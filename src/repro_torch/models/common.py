"""Shared model components: config, norms, rotary embeddings, activations.

Models are plain functions on tensors: params are nested dicts of tensors,
forward functions are `f(params, inputs, cfg) -> outputs`.  Layer stacks are
stored *stacked* on a leading `[L, ...]` axis -- the executor indexes them
with the layer id and the MoE Super Kernel binds the whole stack (one kernel,
layer index as data).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import torch

# ---------------------------------------------------------------------------
# Config
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Architecture description. One instance per architecture.

    Field for field the reference's `repro.models.common.ModelConfig` (so a
    smoke config compares equal apart from `dtype`, which is a torch dtype
    here).  `family` selects the block wiring:
      dense   — decoder-only transformer, dense FFN
      moe     — decoder-only transformer, MoE FFN
      ssm     — attention-free (RWKV6)
      hybrid  — Mamba2 backbone + shared attention block (Zamba2)
      encdec  — encoder-decoder (Seamless-M4T backbone)
    """

    name: str
    family: str
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int

    # --- attention options -------------------------------------------------
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    window_size: Optional[int] = None
    local_per_global: int = 0
    logit_softcap: Optional[float] = None
    nonparametric_norm: bool = False  # OLMo-style LN without scale/bias
    qk_norm: bool = False

    # --- MoE ----------------------------------------------------------------
    num_experts: int = 0
    top_k: int = 0
    num_shared_experts: int = 0
    moe_d_ff: Optional[int] = None  # per-expert hidden dim (d_ff used if None)
    router_renorm: bool = True  # renormalize top-k weights to sum to 1
    capacity_factor: float = 1.25
    dispatch_groups: int = 1

    # --- SSM (Mamba2 / RWKV6) ----------------------------------------------
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv_width: int = 4
    ssm_chunk: int = 128

    # --- hybrid (Zamba2) ----------------------------------------------------
    shared_attn_every: int = 0

    # --- encoder/decoder ----------------------------------------------------
    encoder_layers: int = 0
    decoder_layers: int = 0

    # --- modality frontend stub ---------------------------------------------
    frontend: Optional[str] = None  # None | "audio" | "vision"

    # --- misc ----------------------------------------------------------------
    tie_embeddings: bool = True
    scale_embeddings: bool = False  # gemma-style sqrt(d_model) scaling
    norm_eps: float = 1e-6
    act: str = "silu"
    dtype: Any = torch.bfloat16
    # Sequence length up to which `attention_forward` takes the dense
    # O(S^2)-memory oracle when the caller leaves the choice open.
    attn_chunk: int = 1024
    remat_policy: str = "nothing_saveable"
    # ---- knobs of the reference's SPMD side (carried for field equality) --
    attn_dp_constraint: bool = False
    inner_remat: bool = False
    moe_shard_constraints: bool = False
    gqa_grouped: bool = False
    causal_block_skip: bool = False
    combine_via_gather: bool = False
    no_fsdp: bool = False

    # ------------------------------------------------------------------ utils
    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    @property
    def expert_d_ff(self) -> int:
        return self.moe_d_ff if self.moe_d_ff is not None else self.d_ff

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # Reduced config of the same family for CPU smoke tests.
    def smoke(self) -> "ModelConfig":
        kw: dict[str, Any] = dict(
            num_layers=min(self.num_layers, 4),
            d_model=128,
            num_heads=4,
            num_kv_heads=min(self.num_kv_heads, 4) if self.num_kv_heads else 0,
            head_dim=32,
            d_ff=256,
            vocab_size=512,
            dtype=torch.float32,
            attn_chunk=32,
        )
        if self.num_experts:
            kw.update(num_experts=min(self.num_experts, 8), moe_d_ff=64)
        if self.ssm_state:
            kw.update(ssm_state=16, ssm_head_dim=16, ssm_chunk=16)
        if self.window_size:
            kw.update(window_size=16)
        if self.local_per_global:
            kw.update(num_layers=7, local_per_global=2)
        if self.encoder_layers:
            kw.update(encoder_layers=2, decoder_layers=2)
        if self.shared_attn_every:
            kw.update(num_layers=5, shared_attn_every=2)
        return self.replace(**kw)


# ---------------------------------------------------------------------------
# Parameter counting (for the MODEL_FLOPS = 6*N*D roofline term)
# ---------------------------------------------------------------------------


def _leaves(tree, path: str = ""):
    """(path, tensor) of every leaf of a nested dict / list of tensors, the
    path's keys joined by "/" (list items by index); None leaves skipped."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}/{k}" if path else str(k))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}/{i}" if path else str(i))
    else:
        yield path, tree


def param_count(params) -> int:
    return int(sum(x.numel() for _, x in _leaves(params)))


def active_param_count(params, cfg: ModelConfig) -> int:
    """Parameters touched per token (MoE: only top_k + shared experts active)."""
    total = 0
    for keys, leaf in _leaves(params):
        size = int(leaf.numel())
        if "experts" in keys and cfg.num_experts:
            size = size * cfg.top_k // cfg.num_experts
        total += size
    return total


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, weight: Optional[torch.Tensor],
             eps: float) -> torch.Tensor:
    dtype = x.dtype
    x32 = x.float()
    var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    if weight is not None:
        y = y * weight.float()
    return y.to(dtype)


def layer_norm(x: torch.Tensor, weight, bias, eps: float) -> torch.Tensor:
    """LayerNorm; weight/bias may be None (OLMo non-parametric LN)."""
    dtype = x.dtype
    x32 = x.float()
    mean = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.var(x32, dim=-1, keepdim=True, unbiased=False)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    if weight is not None:
        y = y * weight.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(dtype)


def make_norm_params(cfg: ModelConfig, device, stack: tuple = ()):
    """Norm scale of shape `stack + (d_model,)` (`stack` is the leading
    layer axis of a stacked stage), or None for the non-parametric norm."""
    if cfg.nonparametric_norm:
        return None
    return torch.ones(stack + (cfg.d_model,), dtype=cfg.dtype, device=device)


def apply_norm(x: torch.Tensor, w, cfg: ModelConfig) -> torch.Tensor:
    if cfg.nonparametric_norm:
        return layer_norm(x, None, None, cfg.norm_eps)
    return rms_norm(x, w, cfg.norm_eps)


# ---------------------------------------------------------------------------
# Activations
# ---------------------------------------------------------------------------

_ACTS = {
    "silu": torch.nn.functional.silu,
    # the reference's "gelu" is jax.nn.gelu's default: the tanh approximation
    "gelu": lambda x: torch.nn.functional.gelu(x, approximate="tanh"),
    "relu": torch.relu,
    "gelu_tanh": lambda x: torch.nn.functional.gelu(x, approximate="tanh"),
}


def act_fn(name: str):
    return _ACTS[name]


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------


def rope_frequencies(head_dim: int, theta: float,
                     device=None) -> torch.Tensor:
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=device) / head_dim
    return 1.0 / (theta ** exponent)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: [..., seq, heads, head_dim]; positions: [..., seq]."""
    freqs = rope_frequencies(x.shape[-1], theta, x.device)  # [hd/2]
    angles = positions.float()[..., None] * freqs  # [..., seq, hd/2]
    cos = torch.cos(angles)[..., None, :]  # broadcast over heads
    sin = torch.sin(angles)[..., None, :]
    x32 = x.float()
    x1, x2 = torch.chunk(x32, 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Initializers (seeded `torch.Generator` on the target device)
# ---------------------------------------------------------------------------


def dense_init(gen: torch.Generator, shape, in_dim: int,
               dtype) -> torch.Tensor:
    """Normal(0, 1 / sqrt(in_dim)) of `shape`, drawn on gen's device."""
    w = torch.randn(tuple(shape), generator=gen, device=gen.device,
                    dtype=torch.float32)
    return w.mul_(1.0 / math.sqrt(in_dim)).to(dtype)


def embed_init(gen: torch.Generator, vocab: int, dim: int,
               dtype) -> torch.Tensor:
    w = torch.randn((vocab, dim), generator=gen, device=gen.device,
                    dtype=torch.float32)
    return w.mul_(0.02).to(dtype)


# ---------------------------------------------------------------------------
# Cross entropy
# ---------------------------------------------------------------------------


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       mask=None) -> torch.Tensor:
    """logits [..., V] fp32-accumulated CE; labels int [...]."""
    logits32 = logits.float()
    lse = torch.logsumexp(logits32, dim=-1)
    gold = torch.gather(logits32, -1, labels.long()[..., None])[..., 0]
    nll = lse - gold
    if mask is not None:
        nll = nll * mask
        return torch.sum(nll) / torch.sum(mask).to(nll.dtype).clamp(min=1.0)
    return torch.mean(nll)


def vocab_parallel_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                                 vocab_start: int) -> torch.Tensor:
    """Mean token CE of logits [..., V_local]: this rank's vocab rows
    `vocab_start:vocab_start + V_local` of a vocab split over "model"
    (`pshard.model_parallel`).  The max and the sum of exponentials go
    through the group; each target's logit comes from the rank that owns
    it (zero elsewhere, then summed).  The shift is a constant to autograd,
    as it cancels in the loss's value."""
    from repro_torch.models import pshard
    logits32 = logits.float()
    V = logits32.shape[-1]
    m = pshard.max_over_model(logits32.detach().amax(dim=-1))
    sumexp = torch.sum(torch.exp(logits32 - m[..., None]), dim=-1)
    lse = m + torch.log(pshard.reduce_from_model(sumexp))
    ids = labels.long() - vocab_start
    mine = (ids >= 0) & (ids < V)
    gold = torch.gather(logits32, -1, ids.clamp(0, V - 1)[..., None])[..., 0]
    gold = pshard.reduce_from_model(torch.where(mine, gold,
                                                torch.zeros_like(gold)))
    return torch.mean(lse - gold)
