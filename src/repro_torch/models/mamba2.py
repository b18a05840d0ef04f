"""Mamba2 (SSD) block -- chunked state-space duality algorithm + sequential
oracle.

Follows the minimal SSD formulation of Mamba2 (arXiv:2405.21060): per-head
scalar input-dependent decay a_t = exp(dt_t * A_h), rank-1 state updates with
shared (B, C) projections (single group).  Prefill uses the chunked algorithm
(intra-chunk quadratic + inter-chunk scan); decode carries [B, H, P, N]
state.  The reference runs it as plain array ops (no Pallas kernel), and so
does the port.

Inside a tensor-parallel step (`pshard.model_parallel`), where `in_proj`
holds the rank's contiguous chunk of its columns [z | x | B | C | dt] (read
off its shape), the mixer runs on the rank's SSD heads.  The chunks do not
fall on the five parts' borders, so the projection is gathered whole over
"model" (`pshard.gather_to_model`): each rank reads its heads' z, x and dt
and the B and C every head shares.  The causal conv runs on the channels of
(x, B, C) the rank stores (`conv_w` / `conv_b` and the decode's conv ring
split as `cache_specs` splits them, in chunks that are not the heads'
either), and its output is gathered the same way.  The gated norm's sum of
squares over the whole d_inner is summed over "model"; `out_proj` holds the
rank's rows and the partial outputs add up.  The ssm state holds the rank's
heads.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.models import pshard
from repro_torch.models.common import ModelConfig, dense_init, rms_norm


class MambaState(NamedTuple):
    ssm: torch.Tensor  # [B, H, P, N], fp32
    conv: torch.Tensor  # [B, W-1, conv_channels]


def _dims(cfg: ModelConfig):
    d_inner = cfg.ssm_expand * cfg.d_model
    P = cfg.ssm_head_dim
    H = d_inner // P
    N = cfg.ssm_state
    return d_inner, H, P, N


def init_mamba_params(gen: torch.Generator, cfg: ModelConfig,
                      stack: tuple = ()):
    """`stack` prepends leading axes (the layer axes) to every leaf.
    `A_log`, `dt_bias` and `D` are fp32 whatever `cfg.dtype` says, as in the
    reference."""
    d, dev, dt = cfg.d_model, gen.device, cfg.dtype
    d_inner, H, P, N = _dims(cfg)
    conv_ch = d_inner + 2 * N  # conv over (x, B, C)
    f32 = torch.float32
    conv_w = torch.randn(stack + (cfg.ssm_conv_width, conv_ch), generator=gen,
                         device=dev, dtype=f32)
    A_log = torch.log(torch.linspace(1.0, 16.0, H, dtype=f32, device=dev))
    return {
        # in_proj -> [z, x, B, C, dt]
        "in_proj": dense_init(gen, stack + (d, 2 * d_inner + 2 * N + H), d,
                              dt),
        "conv_w": conv_w.mul_(0.1).to(dt),
        "conv_b": torch.zeros(stack + (conv_ch,), dtype=dt, device=dev),
        "A_log": A_log.expand(stack + (H,)).clone(),
        "dt_bias": torch.zeros(stack + (H,), dtype=f32, device=dev),
        "D": torch.ones(stack + (H,), dtype=f32, device=dev),
        "out_norm": torch.ones(stack + (d_inner,), dtype=dt, device=dev),
        "out_proj": dense_init(gen, stack + (d_inner, d), d_inner, dt),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv, fp32 taps summed in order. x: [B, S, C];
    w: [W, C]."""
    W, S = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, W - 1, 0))
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for i in range(W):
        out = out + xp[:, i:i + S].float() * w[i].float()
    return (out + b.float()).to(x.dtype)


class _Split(NamedTuple):
    """How the mixer's channels lie on this rank: `tp` whether it computes
    over "model" (`in_proj` holds a chunk of its columns), and then the
    rank's first SSD head `h0` of `H` local heads (`P` channels each) and
    its first stored conv channel `c0` of `C` stored ones; `tp` False: all
    of them, from 0."""
    tp: bool
    h0: int
    H: int
    c0: int
    C: int


def _split(p, cfg: ModelConfig) -> _Split:
    d_inner, H, P, N = _dims(cfg)
    conv_ch = d_inner + 2 * N
    if p["in_proj"].shape[-1] == d_inner + conv_ch + H:
        return _Split(False, 0, H, 0, conv_ch)
    n, r = pshard.model_parallel_size(), pshard.model_parallel_rank()
    return _Split(True, r * (H // n), H // n, r * (conv_ch // n),
                  conv_ch // n)


def _split_proj(p, u, cfg: ModelConfig, sp: _Split):
    """(z, xbc, dt) of the input projection: z and dt of the local heads
    (views), xbc whole (gathered over "model" under `sp.tp`)."""
    d_inner, H, P, N = _dims(cfg)
    if sp.tp:
        zxbcdt = pshard.gather_to_model(
            pshard.copy_to_model(u) @ p["in_proj"], -1)
    else:
        zxbcdt = u @ p["in_proj"]
    z, xbc, dt = torch.split(zxbcdt, [d_inner, d_inner + 2 * N, H], dim=-1)
    return (z.narrow(-1, sp.h0 * P, sp.H * P), xbc,
            dt.narrow(-1, sp.h0, sp.H))  # conv applies to xbc


def _local(t: torch.Tensor, sp: _Split) -> torch.Tensor:
    """A replicated per-head leaf ([..., H]) at the local heads (its
    gradient gathered over "model" under `sp.tp`)."""
    return pshard.scatter_to_model(t, -1) if sp.tp else t


def _conv_out(conv: torch.Tensor, sp: _Split, cfg: ModelConfig):
    """(x of the local heads, B, C) of the activated conv output on the
    stored channels (gathered whole over "model" under `sp.tp`)."""
    d_inner, H, P, N = _dims(cfg)
    if sp.tp:
        conv = pshard.gather_to_model(conv, -1)
    x, B, C = torch.split(conv, [d_inner, N, N], dim=-1)
    return x.narrow(-1, sp.h0 * P, sp.H * P), B, C


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """a: [..., Q] -> [..., Q, Q] with out[i,j] = sum_{j<s<=i} a_s (-inf for
    j>i)."""
    Q = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]  # [.., i, j] = sum_{j<s<=i}
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=a.device))
    return diff.masked_fill(~mask, -math.inf)


def _ssd_state0(initial_state, b, H, P, N, device) -> torch.Tensor:
    if initial_state is not None:
        return initial_state.float()
    return torch.zeros((b, H, P, N), dtype=torch.float32, device=device)


def ssd_chunked(x, a_log, B, C, chunk: int, initial_state=None):
    """Chunked SSD scan.

    x:      [b, S, H, P]  (already dt-scaled input)
    a_log:  [b, S, H]     log decay per step (<= 0)
    B, C:   [b, S, N]     shared across heads (single group)
    Returns (y [b, S, H, P] in x's dtype, final_state [b, H, P, N] fp32).
    """
    b, S, H, P = x.shape
    N = B.shape[-1]
    Q = min(chunk, S)
    if S % Q:  # pad: zero inputs contribute nothing, zero a_log keeps state
        pad = Q - S % Q
        y, fs = ssd_chunked(F.pad(x, (0, 0, 0, 0, 0, pad)),
                            F.pad(a_log, (0, 0, 0, pad)),
                            F.pad(B, (0, 0, 0, pad)),
                            F.pad(C, (0, 0, 0, pad)), Q, initial_state)
        return y[:, :S], fs
    nc = S // Q
    xc = x.reshape(b, nc, Q, H, P).float()
    ac = a_log.float().reshape(b, nc, Q, H).permute(0, 3, 1, 2)  # [b,H,nc,Q]
    Bc = B.reshape(b, nc, Q, N).float()
    Cc = C.reshape(b, nc, Q, N).float()

    A_cum = torch.cumsum(ac, dim=-1)  # [b, H, nc, Q]
    # 1) intra-chunk (diagonal block) output
    L = torch.exp(_segsum(ac))  # [b, H, nc, Q, Q]
    CB = torch.einsum("bcln,bcsn->bcls", Cc, Bc)
    Y_diag = torch.einsum("bhcls,bcshp->bclhp", L * CB[:, None], xc)
    # 2) per-chunk end states
    decay_states = torch.exp(A_cum[..., -1:] - A_cum)  # [b, H, nc, Q]
    states = torch.einsum("bcln,bclhp->bchpn", Bc,
                          xc * decay_states.permute(0, 2, 3, 1)[..., None])
    # 3) inter-chunk recurrence (the one loop)
    chunk_decay = torch.exp(A_cum[..., -1])[..., None, None]  # [b,H,nc,1,1]
    s = _ssd_state0(initial_state, b, H, P, N, x.device)
    entering = []
    for c in range(nc):
        entering.append(s)
        s = chunk_decay[:, :, c] * s + states[:, c]
    prev_states = torch.stack(entering, 1)  # [b, nc, H, P, N]
    # 4) state -> output contribution; exp(A_cum): decay from chunk start to
    # position l (inclusive)
    Y_off = torch.einsum("bcln,bchpn->bclhp", Cc, prev_states) \
        * torch.exp(A_cum).permute(0, 2, 3, 1)[..., None]
    y = (Y_diag + Y_off).reshape(b, S, H, P)
    return y.to(x.dtype), s


def ssd_sequential(x, a_log, B, C, initial_state=None):
    """Step-by-step oracle for ssd_chunked."""
    b, S, H, P = x.shape
    N = B.shape[-1]
    s = _ssd_state0(initial_state, b, H, P, N, x.device)
    ys = []
    for t in range(S):
        s = torch.exp(a_log[:, t].float())[..., None, None] * s \
            + x[:, t].float()[..., None] * B[:, t][:, None, None, :].float()
        ys.append(torch.einsum("bhpn,bn->bhp", s, C[:, t].float()))
    return torch.stack(ys, 1).to(x.dtype), s


def _gated_out(p, y, z, u, cfg: ModelConfig, sp: _Split):
    """rms_norm(y ⊙ silu(z)) @ out_proj, in u's dtype.  Under `sp.tp` y and
    z hold the local heads' channels: the norm's sum of squares over the
    whole d_inner is summed over "model", and `out_proj`'s rows' partial
    outputs too."""
    y = y * F.silu(z.float()).to(u.dtype)
    if not sp.tp:
        return rms_norm(y, p["out_norm"], cfg.norm_eps) @ p["out_proj"]
    y32 = y.float()
    ss = pshard.sum_over_model(torch.sum(torch.square(y32), -1,
                                         keepdim=True))
    d_inner = _dims(cfg)[0]
    y = (y32 * torch.rsqrt(ss / d_inner + cfg.norm_eps)
         * p["out_norm"].float()).to(y.dtype)
    return pshard.reduce_from_model(y @ p["out_proj"])


def mamba_forward(p, u: torch.Tensor, cfg: ModelConfig, *,
                  sequential: bool = False, return_state: bool = False):
    """Full-sequence Mamba2 block. u: [B, S, d_model] -> [B, S, d_model]
    (and, with `return_state`, the MambaState a decode continues from: the
    conv ring holds the last W-1 raw inputs of the stored channels,
    zero-padded on the left when S < W-1)."""
    b, S, _ = u.shape
    d_inner, H, P, N = _dims(cfg)
    sp = _split(p, cfg)
    z, xbc_raw, dt = _split_proj(p, u, cfg, sp)
    raw = xbc_raw.narrow(-1, sp.c0, sp.C)  # the stored conv channels
    conv = _causal_conv(raw, p["conv_w"], p["conv_b"])
    x, B, C = _conv_out(F.silu(conv.float()).to(u.dtype), sp, cfg)
    dt = F.softplus(dt.float() + _local(p["dt_bias"], sp))  # [b, S, H]
    A = -torch.exp(_local(p["A_log"], sp))  # [H] negative
    a_log = dt * A  # [b, S, H]
    xh = x.reshape(b, S, sp.H, P)
    x_scaled = (xh.float() * dt[..., None]).to(u.dtype)
    if sequential:
        y, ssm = ssd_sequential(x_scaled, a_log, B, C)
    else:
        y, ssm = ssd_chunked(x_scaled, a_log, B, C, cfg.ssm_chunk)
    y = y.float() + xh.float() * _local(p["D"], sp)[None, None, :, None]
    out = _gated_out(p, y.reshape(b, S, sp.H * P).to(u.dtype), z, u, cfg,
                     sp)
    if return_state:
        W = cfg.ssm_conv_width
        if S >= W - 1:
            conv = raw[:, S - (W - 1):].clone()
        else:
            conv = F.pad(raw, (0, 0, W - 1 - S, 0))
        return out, MambaState(ssm, conv)
    return out


def init_mamba_state(cfg: ModelConfig, batch: int,
                     device="cuda") -> MambaState:
    d_inner, H, P, N = _dims(cfg)
    conv_ch = d_inner + 2 * N
    return MambaState(
        torch.zeros((batch, H, P, N), dtype=torch.float32, device=device),
        torch.zeros((batch, cfg.ssm_conv_width - 1, conv_ch),
                    dtype=cfg.dtype, device=device))


def mamba_decode(p, u: torch.Tensor, state: MambaState, cfg: ModelConfig):
    """One-token decode. u: [B, 1, d_model].  Unlike the reference, which
    returns a new state, this one CONSUMES `state`: the new ssm state and
    the shifted conv ring are written into `state.ssm` / `state.conv` IN
    PLACE, and the same MambaState comes back: (out [B, 1, d], state).
    Over "model" the ring holds the stored channels, whose conv the rank
    computes from its own history (`_conv_out` gathers the rest)."""
    b = u.shape[0]
    d_inner, H, P, N = _dims(cfg)
    sp = _split(p, cfg)
    z, xbc, dt = _split_proj(p, u, cfg, sp)
    xbc = xbc.narrow(-1, sp.c0, sp.C)  # the stored conv channels
    # conv over ring of last W-1 inputs + current
    hist = torch.cat([state.conv, xbc], dim=1)  # [b, W, C]
    conv_out = torch.einsum("bwc,wc->bc", hist.float(), p["conv_w"].float()) \
        + p["conv_b"].float()
    x, B, C = _conv_out(F.silu(conv_out)[:, None, :].to(u.dtype), sp, cfg)
    dt = F.softplus(dt.float() + _local(p["dt_bias"], sp))[:, 0]  # [b, H]
    A = -torch.exp(_local(p["A_log"], sp))
    a = torch.exp(dt * A)  # [b, H]
    xh = x.reshape(b, sp.H, P).float()
    s = a[..., None, None] * state.ssm \
        + (xh * dt[..., None])[..., None] * B[:, 0][:, None, None, :].float()
    y = torch.einsum("bhpn,bn->bhp", s, C[:, 0].float())
    y = y + xh * _local(p["D"], sp)[None, :, None]
    out = _gated_out(p, y.reshape(b, 1, sp.H * P).to(u.dtype), z, u, cfg, sp)
    state.ssm.copy_(s)
    state.conv.copy_(hist[:, 1:])
    return out, state
