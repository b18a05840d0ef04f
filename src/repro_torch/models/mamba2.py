"""Mamba2 (SSD) block -- chunked state-space duality algorithm + sequential
oracle.

Follows the minimal SSD formulation of Mamba2 (arXiv:2405.21060): per-head
scalar input-dependent decay a_t = exp(dt_t * A_h), rank-1 state updates with
shared (B, C) projections (single group).  Prefill uses the chunked algorithm
(intra-chunk quadratic + inter-chunk scan); decode carries [B, H, P, N]
state.  The reference runs it as plain array ops (no Pallas kernel), and so
does the port.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

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


def _split_proj(p, u, cfg: ModelConfig):
    d_inner, H, P, N = _dims(cfg)
    zxbcdt = u @ p["in_proj"]
    z, xbc, dt = torch.split(zxbcdt, [d_inner, d_inner + 2 * N, H], dim=-1)
    return z, xbc, dt  # conv applies to xbc


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


def _gated_out(p, y, z, u, cfg: ModelConfig):
    """rms_norm(y ⊙ silu(z)) @ out_proj, in u's dtype."""
    y = rms_norm(y * F.silu(z.float()).to(u.dtype), p["out_norm"],
                 cfg.norm_eps)
    return y @ p["out_proj"]


def mamba_forward(p, u: torch.Tensor, cfg: ModelConfig, *,
                  sequential: bool = False, return_state: bool = False):
    """Full-sequence Mamba2 block. u: [B, S, d_model] -> [B, S, d_model]
    (and, with `return_state`, the MambaState a decode continues from: the
    conv ring holds the last W-1 raw inputs, zero-padded on the left when
    S < W-1)."""
    b, S, _ = u.shape
    d_inner, H, P, N = _dims(cfg)
    z, xbc_raw, dt = _split_proj(p, u, cfg)
    xbc = _causal_conv(xbc_raw, p["conv_w"], p["conv_b"])
    xbc = F.silu(xbc.float()).to(u.dtype)
    x, B, C = torch.split(xbc, [d_inner, N, N], dim=-1)
    dt = F.softplus(dt.float() + p["dt_bias"])  # [b, S, H]
    A = -torch.exp(p["A_log"])  # [H] negative
    a_log = dt * A  # [b, S, H]
    xh = x.reshape(b, S, H, P)
    x_scaled = (xh.float() * dt[..., None]).to(u.dtype)
    if sequential:
        y, ssm = ssd_sequential(x_scaled, a_log, B, C)
    else:
        y, ssm = ssd_chunked(x_scaled, a_log, B, C, cfg.ssm_chunk)
    y = y.float() + xh.float() * p["D"][None, None, :, None]
    out = _gated_out(p, y.reshape(b, S, d_inner).to(u.dtype), z, u, cfg)
    if return_state:
        W = cfg.ssm_conv_width
        if S >= W - 1:
            conv = xbc_raw[:, S - (W - 1):].clone()
        else:
            conv = F.pad(xbc_raw, (0, 0, W - 1 - S, 0))
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
    PLACE, and the same MambaState comes back: (out [B, 1, d], state)."""
    b = u.shape[0]
    d_inner, H, P, N = _dims(cfg)
    z, xbc, dt = _split_proj(p, u, cfg)
    # conv over ring of last W-1 inputs + current
    hist = torch.cat([state.conv, xbc], dim=1)  # [b, W, C]
    conv_out = torch.einsum("bwc,wc->bc", hist.float(), p["conv_w"].float()) \
        + p["conv_b"].float()
    xbc1 = F.silu(conv_out)[:, None, :].to(u.dtype)
    x, B, C = torch.split(xbc1, [d_inner, N, N], dim=-1)
    dt = F.softplus(dt.float() + p["dt_bias"])[:, 0]  # [b, H]
    A = -torch.exp(p["A_log"])
    a = torch.exp(dt * A)  # [b, H]
    xh = x.reshape(b, H, P).float()
    s = a[..., None, None] * state.ssm \
        + (xh * dt[..., None])[..., None] * B[:, 0][:, None, None, :].float()
    y = torch.einsum("bhpn,bn->bhp", s, C[:, 0].float())
    y = y + xh * p["D"][None, :, None]
    out = _gated_out(p, y.reshape(b, 1, d_inner).to(u.dtype), z, u, cfg)
    state.ssm.copy_(s)
    state.conv.copy_(hist[:, 1:])
    return out, state
