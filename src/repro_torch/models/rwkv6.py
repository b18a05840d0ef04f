"""RWKV-6 ("Finch") block: time-mix with data-dependent per-channel decay +
channel-mix.  Chunked parallel prefill + sequential oracle + one-token decode.

Recurrence (per head, k/v head size P):
    S_t = diag(w_t) S_{t-1} + k_t v_t^T          (w_t in (0,1), data-dependent)
    y_t = r_t^T S_{t-1} + (r_t . (u ⊙ k_t)) v_t   (u = per-channel bonus)

The chunked algorithm factorizes the pairwise decay exp(Lprev_i - L_j) into
(r_i ⊙ exp(Lprev_i - c)) · (k_j ⊙ exp(c - L_j)) with a per-chunk/channel
midpoint offset c and exponent clamping -- two matmuls per chunk instead of
a [Q,Q,P] intermediate.  Pairs whose true weight underflows (< e^-60) are
the only ones affected by the clamp.  The intra-chunk terms of every chunk
are computed at once; only the cross-chunk state recurrence is a loop.
The reference runs all of this as plain array ops (no Pallas kernel), and
so does the port.

Inside a tensor-parallel step (`pshard.model_parallel`) the time mix runs on
the rank's wkv heads -- `wr` / `wk` / `wv` / `wg` and `w_lora_b` hold their
columns, `wo` their rows, read off the leaves' shapes -- and the channel mix
on the rank's hidden columns (`wk`) and rows (`wv`), each block's output
summed over "model"; the replicated per-channel leaves (`w_base`, `u`,
`ln_w`) are sliced to the rank's channels.  The wkv state then holds the
rank's heads.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.models import pshard
from repro_torch.models.common import ModelConfig, dense_init

CLAMP = 60.0


class RWKVState(NamedTuple):
    wkv: torch.Tensor  # [B, H, P, P] (k-dim, v-dim), fp32
    shift_tm: torch.Tensor  # [B, d] last token for time-mix shift
    shift_cm: torch.Tensor  # [B, d] last token for channel-mix shift


def _dims(cfg: ModelConfig):
    P = cfg.ssm_head_dim
    H = cfg.d_model // P
    return H, P


def init_rwkv_params(gen: torch.Generator, cfg: ModelConfig,
                     stack: tuple = ()):
    """`stack` prepends leading axes (the [L] layer axis) to every leaf.  The
    decay base `w_base` and the bonus `u` are fp32 whatever `cfg.dtype`
    says, as in the reference."""
    d, dev, dt = cfg.d_model, gen.device, cfg.dtype
    lora = max(32, d // 64)

    def full(n, value, dtype=dt):
        return torch.full(stack + (n,), value, dtype=dtype, device=dev)

    return {
        "time_mix": {
            "mu_r": full(d, 0.5), "mu_k": full(d, 0.5), "mu_v": full(d, 0.5),
            "mu_w": full(d, 0.5), "mu_g": full(d, 0.5),
            "wr": dense_init(gen, stack + (d, d), d, dt),
            "wk": dense_init(gen, stack + (d, d), d, dt),
            "wv": dense_init(gen, stack + (d, d), d, dt),
            "wg": dense_init(gen, stack + (d, d), d, dt),
            "wo": dense_init(gen, stack + (d, d), d, dt),
            # data-dependent decay: w_t = exp(-exp(w_base + tanh(x A) B))
            "w_base": full(d, -1.0, torch.float32),
            "w_lora_a": dense_init(gen, stack + (d, lora), d, dt),
            "w_lora_b": torch.zeros(stack + (lora, d), dtype=dt, device=dev),
            "u": full(d, 0.5, torch.float32),  # bonus
            "ln_w": full(d, 1.0),  # group-norm scale per channel
        },
        "channel_mix": {
            "mu_k": full(d, 0.5), "mu_r": full(d, 0.5),
            "wk": dense_init(gen, stack + (d, cfg.d_ff), d, dt),
            "wv": dense_init(gen, stack + (cfg.d_ff, d), cfg.d_ff, dt),
            "wr": dense_init(gen, stack + (d, d), d, dt),
        },
    }


def _token_shift(x: torch.Tensor, last=None) -> torch.Tensor:
    """Previous token (zeros / `last` for position 0). x: [B, S, d]."""
    first = x.new_zeros(x[:, :1].shape) if last is None else last[:, None, :]
    return torch.cat([first, x[:, :-1]], dim=1)


def _lerp(x, xx, mu):
    return x + (xx - x) * mu.to(x.dtype)


def _decay_log(p_tm, xw: torch.Tensor, tp: bool = False) -> torch.Tensor:
    """log w_t in (-inf, 0), fp32. xw: [B, S, d] (already mu-mixed).  `tp`:
    `w_lora_b` holds the rank's channels; the LoRA's hidden activation is
    computed whole and read for them, so its gradient is summed over
    "model" there, after the whole computation."""
    lora = torch.tanh(xw @ p_tm["w_lora_a"])
    if tp:
        lora = pshard.copy_to_model(lora)
    lora = lora.float() @ p_tm["w_lora_b"].float()
    w_base = pshard.scatter_to_model(p_tm["w_base"], -1) if tp \
        else p_tm["w_base"]
    ww = w_base + lora
    return -torch.exp(torch.clamp(ww, -8.0, 4.0))  # clip keeps exp sane


# ---------------------------------------------------------------------------
# WKV (chunked + sequential)
# ---------------------------------------------------------------------------


def _state0(initial_state, B, H, P, N, device) -> torch.Tensor:
    if initial_state is not None:
        return initial_state.float()
    return torch.zeros((B, H, P, N), dtype=torch.float32, device=device)


def wkv_sequential(r, k, v, logw, u, initial_state=None):
    """Oracle. r,k,v: [B, S, H, P]; logw: [B, S, H, P]; u: [H, P].
    Returns (y [B, S, H, P] in r's dtype, final state [B, H, P, P] fp32)."""
    B, S, H, P = r.shape
    s = _state0(initial_state, B, H, P, P, r.device)
    ys = []
    for t in range(S):
        rt, kt, vt = (a[:, t].float() for a in (r, k, v))  # [B, H, P]
        y = torch.einsum("bhk,bhkv->bhv", rt, s) \
            + (rt * (u[None] * kt)).sum(-1)[..., None] * vt
        s = torch.exp(logw[:, t])[..., None] * s \
            + kt[..., None] * vt[..., None, :]
        ys.append(y)
    return torch.stack(ys, 1).to(r.dtype), s


def wkv_chunked(r, k, v, logw, u, chunk: int, initial_state=None):
    """Chunked parallel WKV. Shapes as wkv_sequential."""
    B, S, H, P = r.shape
    Q = min(chunk, S)
    if S % Q:  # pad: zero k adds nothing to state, zero logw keeps decay = 1
        pad = Q - S % Q
        padded = [F.pad(a, (0, 0, 0, 0, 0, pad)) for a in (r, k, v, logw)]
        y, fs = wkv_chunked(*padded, u, Q, initial_state)
        return y[:, :S], fs
    nc = S // Q

    def cshape(a):  # [B, S, H, P] -> [B, nc, H, Q, P], fp32
        return a.reshape(B, nc, Q, H, P).permute(0, 1, 3, 2, 4).float()

    rc, kc, vc, wc = map(cshape, (r, k, v, logw))
    L = torch.cumsum(wc, dim=-2)  # inclusive
    Lprev = L - wc  # exclusive
    Lend = L[..., -1:, :]  # [B, nc, H, 1, P]
    c = 0.5 * Lend  # midpoint offset per channel

    def ex(a):
        return torch.exp(torch.clamp(a, -CLAMP, CLAMP))

    r_hat = rc * ex(Lprev - c)
    k_hat = kc * ex(c - L)
    k_end = kc * ex(Lend - L)
    r_in = rc * ex(Lprev)
    ku = kc * u.float()[None, None, :, None, :]

    # intra-chunk pairs j < i (factorized pairwise decay), every chunk at once
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=r.device),
                      diagonal=-1)
    A = torch.einsum("bnhip,bnhjp->bnhij", r_hat, k_hat)
    A = A.masked_fill(~mask, 0.0)
    y = torch.einsum("bnhij,bnhjp->bnhip", A, vc)
    # current-token bonus: (r_i . (u ⊙ k_i)) v_i -- raw (undecayed) r, k
    y = y + (rc * ku).sum(-1)[..., None] * vc
    # cross-chunk: r_i^T diag(exp(Lprev_i)) s, s the state entering chunk n;
    # s' = diag(exp(Lend)) s + Σ_j exp(Lend - L_j) k_j v_j^T (the one loop)
    own = torch.einsum("bnhjk,bnhjv->bnhkv", k_end, vc)
    decay = ex(Lend)[..., 0, :, None]  # [B, nc, H, P, 1]
    s = _state0(initial_state, B, H, P, P, r.device)
    entering = []
    for n in range(nc):
        entering.append(s)
        s = decay[:, n] * s + own[:, n]
    y = y + torch.einsum("bnhik,bnhkv->bnhiv", r_in,
                         torch.stack(entering, 1))
    y = y.permute(0, 1, 3, 2, 4).reshape(B, S, H, P)
    return y.to(r.dtype), s


# ---------------------------------------------------------------------------
# Block forward
# ---------------------------------------------------------------------------


def _group_norm(x: torch.Tensor, scale: torch.Tensor, eps: float,
                H: int) -> torch.Tensor:
    """Per-head LayerNorm over P then per-channel scale. x: [B, S, d]."""
    B, S, d = x.shape
    xh = x.reshape(B, S, H, d // H).float()
    mean = torch.mean(xh, dim=-1, keepdim=True)
    var = torch.var(xh, dim=-1, keepdim=True, unbiased=False)
    y = (xh - mean) * torch.rsqrt(var + eps)
    return (y.reshape(B, S, d) * scale.float()).to(x.dtype)


def time_mix_forward(p_tm, x: torch.Tensor, cfg: ModelConfig, *,
                     sequential: bool = False, last=None, state=None):
    """x: [B, S, d] -> (y, final_wkv_state): the state over the heads `wr`
    holds (all, or the rank's over "model")."""
    B, S, d = x.shape
    _, P = _dims(cfg)
    d_loc = p_tm["wr"].shape[-1]
    H = d_loc // P
    tp = d_loc != d
    xx = _token_shift(x, last)
    xr = _lerp(x, xx, p_tm["mu_r"])
    xk = _lerp(x, xx, p_tm["mu_k"])
    xv = _lerp(x, xx, p_tm["mu_v"])
    xw = _lerp(x, xx, p_tm["mu_w"])
    xg = _lerp(x, xx, p_tm["mu_g"])
    if tp:  # whole inputs to the rank's columns
        xr, xk, xv, xg = map(pshard.copy_to_model, (xr, xk, xv, xg))
    r = (xr @ p_tm["wr"]).reshape(B, S, H, P)
    k = (xk @ p_tm["wk"]).reshape(B, S, H, P)
    v = (xv @ p_tm["wv"]).reshape(B, S, H, P)
    g = F.silu((xg @ p_tm["wg"]).float()).to(x.dtype)
    logw = _decay_log(p_tm, xw, tp).reshape(B, S, H, P)
    u, ln_w = p_tm["u"], p_tm["ln_w"]
    if tp:
        u, ln_w = (pshard.scatter_to_model(t, -1) for t in (u, ln_w))
    u = u.reshape(H, P)
    if sequential:
        y, fs = wkv_sequential(r, k, v, logw, u, state)
    else:
        y, fs = wkv_chunked(r, k, v, logw, u, cfg.ssm_chunk, state)
    y = _group_norm(y.reshape(B, S, d_loc), ln_w, cfg.norm_eps, H)
    out = (y * g) @ p_tm["wo"]
    return (pshard.reduce_from_model(out) if tp else out), fs


def channel_mix_forward(p_cm, x: torch.Tensor, cfg: ModelConfig, last=None):
    """`wk` / `wv` may hold the rank's hidden columns / rows: the rows'
    partial products are summed over "model" before they gate `rr`, which
    the replicated `wr` gives whole."""
    xx = _token_shift(x, last)
    xk = _lerp(x, xx, p_cm["mu_k"])
    xr = _lerp(x, xx, p_cm["mu_r"])
    tp = p_cm["wk"].shape[-1] != cfg.d_ff
    if tp:
        xk = pshard.copy_to_model(xk)
    kk = torch.square(torch.relu((xk @ p_cm["wk"]).float()))
    rr = torch.sigmoid((xr @ p_cm["wr"]).float())
    kv = kk.to(x.dtype) @ p_cm["wv"]
    if tp:
        kv = pshard.reduce_from_model(kv)
    return (rr * kv.float()).to(x.dtype)


def init_rwkv_state(cfg: ModelConfig, batch: int,
                    device="cuda") -> RWKVState:
    H, P = _dims(cfg)
    return RWKVState(
        torch.zeros((batch, H, P, P), dtype=torch.float32, device=device),
        torch.zeros((batch, cfg.d_model), dtype=cfg.dtype, device=device),
        torch.zeros((batch, cfg.d_model), dtype=cfg.dtype, device=device))
