"""LM core: stage machinery over heterogeneous layer stacks.

A model is a sequence of *stages*; each stage holds its layers' params
stacked on leading layer axes.  Stage kinds (the reference's):

  decoder  — uniform causal decoder layers (dense or MoE FFN, optional window)
  gemma    — superblocks of `lpg` sliding-window layers + 1 global layer
  rwkv     — RWKV6 blocks
  zamba    — superblocks of `every` Mamba2 layers + one SHARED attention block
  mamba    — plain Mamba2 layers (zamba tail)

Three passes per stage kind: forward, prefill (forward + caches), decode
(one token, the caches consumed: written in place).  Layers run in a Python
loop over views of the stacked params; the MoE stage's layer id is device
data, which is what lets it run through the layer-oblivious Super Kernel.
The forward is differentiable on both devices (the kernels' autograd
Functions carry the gradient on the card); `remat` recomputes each layer
(or superblock) in the backward, as the reference's `jax.checkpoint` does.
"""
from __future__ import annotations

import functools
import math
from typing import Any, Callable, Optional

import torch
import torch.utils.checkpoint

from repro_torch.models import blocks as B
from repro_torch.models import pshard
from repro_torch.models.attention import KVCache
from repro_torch.models.common import (ModelConfig, apply_norm,
                                       cross_entropy_loss, dense_init,
                                       embed_init, make_norm_params,
                                       vocab_parallel_cross_entropy)
from repro_torch.models.mamba2 import init_mamba_state
from repro_torch.models.moe import MoEAux
from repro_torch.models.rwkv6 import init_rwkv_state

# The reference's remat policies.  Every one but "none" recomputes the whole
# layer here: torch's checkpoint keeps no chosen intermediates (jax's
# dots_saveable policies save the matrix products), so those two are full
# recompute too -- more time, the same numbers.
REMAT_POLICIES = ("none", "nothing_saveable", "dots_saveable",
                  "dots_with_no_batch_dims_saveable")

# ---------------------------------------------------------------------------
# Stage specs
# ---------------------------------------------------------------------------


def lm_stages(cfg: ModelConfig):
    """Returns [(kind, n, opts), ...]."""
    if cfg.family in ("dense", "moe"):
        if cfg.local_per_global:
            per = cfg.local_per_global + 1
            nb, tail = divmod(cfg.num_layers, per)
            stages = []
            if nb:
                stages.append(("gemma", nb, {"lpg": cfg.local_per_global}))
            if tail:
                stages.append(("decoder", tail,
                               {"moe": False, "window": cfg.window_size}))
            return stages
        return [("decoder", cfg.num_layers,
                 {"moe": cfg.family == "moe", "window": cfg.window_size})]
    if cfg.family == "ssm":
        return [("rwkv", cfg.num_layers, {})]
    if cfg.family == "hybrid":
        nb, tail = divmod(cfg.num_layers, cfg.shared_attn_every)
        stages = [("zamba", nb, {"every": cfg.shared_attn_every})]
        if tail:
            stages.append(("mamba", tail, {}))
        return stages
    raise ValueError(f"unknown family {cfg.family}")


def _init_stage(gen: torch.Generator, kind: str, n: int, opts: dict,
                cfg: ModelConfig):
    if kind == "decoder":
        return B.init_decoder_block_params(gen, cfg, moe=opts["moe"],
                                           stack=(n,))
    if kind == "gemma":
        # [n, lpg, ...] local layers and [n, ...] global ones, the
        # reference's layout (so bridged params carry over unchanged)
        return {"local": B.init_decoder_block_params(gen, cfg,
                                                     stack=(n, opts["lpg"])),
                "global": B.init_decoder_block_params(gen, cfg, stack=(n,))}
    if kind == "rwkv":
        return B.init_rwkv_block_params(gen, cfg, stack=(n,))
    if kind == "zamba":  # [n, every, ...] mamba layers
        return B.init_mamba_block_params(gen, cfg, stack=(n, opts["every"]))
    if kind == "mamba":
        return B.init_mamba_block_params(gen, cfg, stack=(n,))
    raise ValueError(kind)


def init_lm_params(gen: torch.Generator, cfg: ModelConfig, device=None):
    """Random parameters from a seeded generator, drawn on the generator's
    device (pass `device` to check it is the one you meant).  The numbers
    differ from the reference's for the same seed; parity tests bridge the
    reference's parameters instead (`repro_torch.bridge`)."""
    if device is not None and torch.device(device).type != gen.device.type:
        raise ValueError(f"generator lives on {gen.device}, not {device}")
    params: dict[str, Any] = {
        "embed": embed_init(gen, cfg.vocab_size, cfg.d_model, cfg.dtype),
        "stages": [_init_stage(gen, kind, n, opts, cfg)
                   for kind, n, opts in lm_stages(cfg)],
        "final_norm": make_norm_params(cfg, gen.device),
    }
    if cfg.family == "hybrid":
        params["shared_attn"] = B.init_shared_attn_params(gen, cfg)
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(
            gen, (cfg.d_model, cfg.vocab_size), cfg.d_model, cfg.dtype)
    return params


# ---------------------------------------------------------------------------
# Embedding / head
# ---------------------------------------------------------------------------


def _vocab_start(w_rows: int, cfg: ModelConfig) -> Optional[int]:
    """The first vocab id of this rank's rows where the embedding (or the
    head) holds a vocab shard over "model" (`pshard.model_parallel`), else
    None."""
    if w_rows == cfg.vocab_size:
        return None
    return pshard.model_parallel_rank() * w_rows


def embed_tokens(params, tokens, embeddings, cfg: ModelConfig):
    """The token embeddings; a vocab shard looks up the ids it owns, zeros
    for the others, and the ranks' rows add up over "model"."""
    if embeddings is not None:
        h = embeddings.to(cfg.dtype)
    else:
        w = params["embed"]
        start = _vocab_start(w.shape[0], cfg)
        if start is None:
            h = w[tokens.long()]
        else:
            ids = tokens.long() - start
            mine = (ids >= 0) & (ids < w.shape[0])
            rows = w[ids.clamp(0, w.shape[0] - 1)]
            h = pshard.reduce_from_model(
                torch.where(mine[..., None], rows, torch.zeros_like(rows)))
    if cfg.scale_embeddings:
        # sqrt(d_model) rounded to the model's dtype first, as the reference
        # multiplies by it (a host float: no device copy, no sync)
        h = h * float(torch.tensor(math.sqrt(cfg.d_model), dtype=cfg.dtype))
    return h


def _head_weight(params, cfg: ModelConfig):
    return params["embed"].T if cfg.tie_embeddings else params["lm_head"]


def lm_head(params, h, cfg: ModelConfig):
    """Logits [..., V]; a vocab shard's logits are gathered over "model"."""
    w = _head_weight(params, cfg)
    if _vocab_start(w.shape[-1], cfg) is None:
        return h @ w
    return pshard.gather_from_model(pshard.copy_to_model(h) @ w, -1)


# ---------------------------------------------------------------------------
# Stage passes — forward
# ---------------------------------------------------------------------------


def layer_slice(sp, l):
    """Layer l's params (an index or a tuple of indices into the stacked
    axes) out of a stacked stage: views, no copies."""
    if isinstance(sp, dict):
        return {k: layer_slice(v, l) for k, v in sp.items()}
    return None if sp is None else sp[l]


def _zero_aux(cfg: ModelConfig, device) -> MoEAux:
    z = torch.zeros((), device=device)
    return MoEAux(z, z, torch.zeros((max(cfg.num_experts, 1),),
                                    device=device))


def _mean_aux(auxs) -> MoEAux:
    return MoEAux(*(torch.stack(f).mean(0) for f in zip(*auxs)))


def _gemma_blocks(sp, n: int, lpg: int):
    """(local layers' params, global layer's params) of each superblock."""
    for i in range(n):
        blk = layer_slice(sp, i)
        yield [layer_slice(blk["local"], j) for j in range(lpg)], blk["global"]


def _zamba_blocks(sp, n: int, every: int):
    """The mamba layers' params of each zamba superblock."""
    for i in range(n):
        blk = layer_slice(sp, i)
        yield [layer_slice(blk, j) for j in range(every)]


def _maybe_remat(body: Callable, cfg: ModelConfig, remat: bool) -> Callable:
    """`body` (one layer, or one superblock) recomputed in the backward
    under `torch.utils.checkpoint` (non-reentrant), as the reference's
    `_maybe_remat`; `body` itself where remat is off or the policy is
    "none"."""
    if not remat or cfg.remat_policy == "none":
        return body
    if cfg.remat_policy not in REMAT_POLICIES:
        raise ValueError(f"unknown remat_policy {cfg.remat_policy!r}")

    def recomputed(*args, **kwargs):
        return torch.utils.checkpoint.checkpoint(body, *args,
                                                 use_reentrant=False,
                                                 **kwargs)

    return recomputed


def _gemma_plans(plan, n: int, lpg: int) -> list:
    """`_gemma_blocks` of a stage's LeafGathers, or Nones without them."""
    if plan is None:
        return [([None] * lpg, None)] * n
    return list(_gemma_blocks(plan, n, lpg))


def _gemma_block(local, glob, h, cfg: ModelConfig, use_dense, plan):
    """One superblock; `plan`: the LeafGathers of its local and global
    layers (`_gemma_plans`), each layer gathered just before it runs."""
    lplans, gplan = plan
    for lp, pl in zip(local, lplans):
        h, _ = B.decoder_block_forward(pshard.gather_tree(lp, pl), h, cfg,
                                       window=cfg.window_size,
                                       use_dense=use_dense)
    h, _ = B.decoder_block_forward(pshard.gather_tree(glob, gplan), h, cfg,
                                   window=None, use_dense=use_dense)
    return h


def _gathered(block: Callable) -> Callable:
    """`block` taking one layer's stored shards and their LeafGathers
    (`pshard.stage_gathers`) first: the layer is gathered inside the body
    `_maybe_remat` wraps, so remat's recompute gathers it again in the
    backward and no gathered layer outlives its use."""
    def body(lp, plan, *args, **kwargs):
        return block(pshard.gather_tree(lp, plan), *args, **kwargs)

    return body


def _zamba_plans(plan, n: int, every: int) -> list:
    """`_zamba_blocks` of a stage's LeafGathers, or Nones without them."""
    if plan is None:
        return [[None] * every] * n
    return list(_zamba_blocks(plan, n, every))


def _zamba_block(mambas, shared, h, emb, cfg: ModelConfig, use_dense,
                 plans):
    """One superblock; `plans`: its mamba layers' LeafGathers, each layer
    gathered just before it runs (the shared block is gathered once, with
    the step's top-level params)."""
    for lp, pl in zip(mambas, plans):
        h = B.mamba_block_forward(pshard.gather_tree(lp, pl), h, cfg)
    return B.shared_attn_forward(shared, h, emb, cfg, use_dense=use_dense)


def _stage_forward(sp, h, kind, n, opts, cfg: ModelConfig, *, moe_mode,
                   use_dense, gmm, emb, shared, remat=False, plan=None):
    """`plan`: the stage's tree of LeafGathers inside a mesh step that
    gathers per layer."""
    if kind in ("rwkv", "mamba"):
        block = _maybe_remat(_gathered(
            B.rwkv_block_forward if kind == "rwkv"
            else B.mamba_block_forward), cfg, remat)
        for l in range(n):
            h = block(layer_slice(sp, l), layer_slice(plan, l), h, cfg)
        return h, _zero_aux(cfg, h.device)
    if kind == "zamba":
        block = _maybe_remat(_zamba_block, cfg, remat)
        for mambas, pl in zip(_zamba_blocks(sp, n, opts["every"]),
                              _zamba_plans(plan, n, opts["every"])):
            h = block(mambas, shared, h, emb, cfg, use_dense, pl)
        return h, _zero_aux(cfg, h.device)
    if kind == "gemma":
        block = _maybe_remat(_gemma_block, cfg, remat)
        for (local, glob), pl in zip(_gemma_blocks(sp, n, opts["lpg"]),
                                     _gemma_plans(plan, n, opts["lpg"])):
            h = block(local, glob, h, cfg, use_dense, pl)
        return h, _zero_aux(cfg, h.device)
    lids = torch.arange(n, dtype=torch.int32, device=h.device) \
        if gmm is not None else None
    kw = dict(window=opts.get("window"), moe=opts["moe"], moe_mode=moe_mode,
              use_dense=use_dense, gmm=gmm)
    block = _maybe_remat(_gathered(B.decoder_block_forward), cfg, remat)
    auxs = []
    for l in range(n):
        lid = None if lids is None else lids[l:l + 1]
        h, aux = block(layer_slice(sp, l), layer_slice(plan, l), h, cfg,
                       layer_id=lid, **kw)
        auxs.append(aux if aux is not None else _zero_aux(cfg, h.device))
    return h, _mean_aux(auxs)


def lm_backbone(params, cfg: ModelConfig, tokens=None, embeddings=None, *,
                moe_mode: str = "capacity", use_dense: Optional[bool] = None,
                gmm: Optional[Callable] = None, remat: bool = False):
    """Embed + all stages + final norm. Returns (h [B,S,d], MoEAux): the
    aux is averaged over each stage's layers, then over the stages, as in
    the reference (zeros for a stage without experts).

    `gmm` replaces the capacity mode's expert matmul and gets each layer's
    id as DEVICE data: a one-element view into one `torch.arange(L)` per
    stage and call, so no layer costs a host-to-device copy.  Zamba's shared
    attention reads the embedded input beside the hidden state.  `remat`:
    each layer (superblock) recomputed in the backward (`_maybe_remat`)."""
    h = embed_tokens(params, tokens, embeddings, cfg)
    emb0 = h
    auxs = []
    plans = pshard.stage_gathers() or [None] * len(params["stages"])
    for sp, (kind, n, opts), plan in zip(params["stages"], lm_stages(cfg),
                                         plans):
        h, aux = _stage_forward(sp, h, kind, n, opts, cfg, moe_mode=moe_mode,
                                use_dense=use_dense, gmm=gmm, emb=emb0,
                                shared=params.get("shared_attn"), remat=remat,
                                plan=plan)
        auxs.append(aux)
    return apply_norm(h, params["final_norm"], cfg), _mean_aux(auxs)


def lm_forward(params, cfg: ModelConfig, tokens=None, embeddings=None, *,
               moe_mode: str = "capacity", use_dense: Optional[bool] = None,
               gmm: Optional[Callable] = None, remat: bool = False):
    """Full logits (use for small scales / sampling)."""
    h, aux = lm_backbone(params, cfg, tokens, embeddings, moe_mode=moe_mode,
                         use_dense=use_dense, gmm=gmm, remat=remat)
    return lm_head(params, h, cfg), aux


# ---------------------------------------------------------------------------
# Loss (blocked CE, so [B,S,V] logits are never materialised at once)
# ---------------------------------------------------------------------------


def blocked_ce(h: torch.Tensor, w: torch.Tensor, labels: torch.Tensor,
               ce_block: int, vocab_start: Optional[int] = None
               ) -> torch.Tensor:
    """Mean token CE of logits h @ w over `ce_block`-position blocks (one
    block where S is not a multiple).  With several blocks each is
    recomputed in the backward, as the reference checkpoints its scan body,
    so no block's [B, C, V] logits outlive it (and a vocab shard's
    collectives run again there).  `vocab_start`: `w` holds the vocab
    columns from there on, this rank's shard over "model"
    (`vocab_parallel_cross_entropy`)."""
    Bsz, S, _ = h.shape
    C = min(ce_block, S)
    if S % C:
        C = S  # fallback: single block
    nb = S // C

    def blk(hb, lb):
        if vocab_start is None:
            return cross_entropy_loss(hb @ w, lb) * (Bsz * C)
        return vocab_parallel_cross_entropy(
            pshard.copy_to_model(hb) @ w, lb, vocab_start) * (Bsz * C)

    if nb > 1:
        blk = functools.partial(torch.utils.checkpoint.checkpoint, blk,
                                use_reentrant=False)
    total = torch.zeros((), device=h.device)
    for i in range(nb):
        total = total + blk(h[:, i * C:(i + 1) * C],
                            labels[:, i * C:(i + 1) * C])
    return total / (Bsz * S)


def lm_loss(params, cfg: ModelConfig, tokens=None, labels=None,
            embeddings=None, *, aux_coef: float = 0.01, ce_block: int = 512,
            moe_mode: str = "capacity", gmm: Optional[Callable] = None,
            remat: bool = True):
    """(loss, metrics): mean token CE over `ce_block`-position blocks plus
    `aux_coef` x the MoE load-balance loss, as the reference computes them.
    Differentiable; `remat` (the reference's default, True) recomputes each
    layer in the backward per `cfg.remat_policy` (`_maybe_remat`)."""
    h, aux = lm_backbone(params, cfg, tokens, embeddings, moe_mode=moe_mode,
                         gmm=gmm, remat=remat)
    w = _head_weight(params, cfg)
    ce = blocked_ce(h, w, labels, ce_block, _vocab_start(w.shape[-1], cfg))
    loss = ce + aux_coef * aux.load_balance_loss
    metrics = {"ce": ce, "load_balance": aux.load_balance_loss,
               "dropped_fraction": aux.dropped_fraction}
    return loss, metrics


# ---------------------------------------------------------------------------
# Stage passes — prefill (forward + caches)
# ---------------------------------------------------------------------------


def _stack(caches):
    """Per-layer caches (KVCache, RWKVState or MambaState) -> one of the
    same kind stacked on a leading layer axis."""
    return type(caches[0])(*(torch.stack(f) for f in zip(*caches)))


def _stage_prefill(sp, h, kind, n, opts, cfg: ModelConfig, *, max_len,
                   use_dense, emb, shared, plan=None, seq=None):
    """`plan`: the stage's tree of LeafGathers and `seq` its caches' tree of
    SeqShards inside a mesh serving step: each layer gathered just before
    it runs, each KV cache kept as the rank's shard of its sequence
    (`pshard.sequence_parallel`); a recurrent state is the rank's shard
    as the layer computes it (its heads and stored conv channels)."""
    if kind in ("rwkv", "mamba"):
        block = B.rwkv_block_prefill if kind == "rwkv" \
            else B.mamba_block_prefill
        states = []
        for l in range(n):
            h, st = block(pshard.gather_tree(layer_slice(sp, l),
                                             layer_slice(plan, l)), h, cfg)
            states.append(st)
        return h, _stack(states)
    if kind == "zamba":
        mc, ac = [], []
        shared_seq = seq["shared"] if seq else None
        for mambas, pls in zip(_zamba_blocks(sp, n, opts["every"]),
                               _zamba_plans(plan, n, opts["every"])):
            states = []
            for lp, pl in zip(mambas, pls):
                h, st = B.mamba_block_prefill(pshard.gather_tree(lp, pl), h,
                                              cfg)
                states.append(st)
            mc.append(_stack(states))
            with pshard.sequence_parallel(shared_seq):
                h, c = B.shared_attn_prefill(shared, h, emb, cfg,
                                             max_len=max_len,
                                             use_dense=use_dense)
            ac.append(c)
        return h, {"mamba": _stack(mc), "shared": _stack(ac)}
    if kind == "gemma":
        seq = seq or {"local": None, "global": None}
        local, glob = [], []
        for (lps, gp), (lpl, gpl) in zip(_gemma_blocks(sp, n, opts["lpg"]),
                                         _gemma_plans(plan, n, opts["lpg"])):
            lc = []
            for lp, pl in zip(lps, lpl):
                with pshard.sequence_parallel(seq["local"]):
                    h, c = B.decoder_block_prefill(
                        pshard.gather_tree(lp, pl), h, cfg,
                        window=cfg.window_size, use_dense=use_dense)
                lc.append(c)
            local.append(_stack(lc))
            with pshard.sequence_parallel(seq["global"]):
                h, c = B.decoder_block_prefill(pshard.gather_tree(gp, gpl), h,
                                               cfg, max_len=max_len,
                                               use_dense=use_dense)
            glob.append(c)
        return h, {"local": _stack(local), "global": _stack(glob)}
    layer = []
    for l in range(n):
        with pshard.sequence_parallel(seq):
            h, cache = B.decoder_block_prefill(
                pshard.gather_tree(layer_slice(sp, l), layer_slice(plan, l)),
                h, cfg, window=opts.get("window"), moe=opts["moe"],
                max_len=max_len, use_dense=use_dense)
        layer.append(cache)
    return h, _stack(layer)


def lm_prefill(params, cfg: ModelConfig, tokens=None, embeddings=None, *,
               max_len: Optional[int] = None,
               use_dense: Optional[bool] = None):
    """Returns (last-position logits [B, V], caches): per stage, as the
    reference's scans stack them -- a decoder stage's `KVCache` with k/v
    [L, B, S, kvh, hd] and length [L]; a gemma stage's {"local": KVCache
    [n, lpg, B, window, kvh, hd], "global": KVCache [n, B, max_len, kvh,
    hd]}; an rwkv stage's `RWKVState` [L, ...]; a zamba stage's {"mamba":
    MambaState [n, every, ...], "shared": KVCache [n, ...] (one per
    application of the shared block)}; a mamba stage's `MambaState`
    [L, ...].  Inside a mesh serving step (`launch.steps.
    build_sharded_prefill_step`) each layer is gathered per
    `pshard.stage_gathers()` and each cache is the rank's shard (a KV
    cache's sequence per `pshard.stage_sequences()`)."""
    h = embed_tokens(params, tokens, embeddings, cfg)
    emb0 = h
    caches = []
    none = [None] * len(params["stages"])
    for sp, (kind, n, opts), plan, seq in zip(
            params["stages"], lm_stages(cfg), pshard.stage_gathers() or none,
            pshard.stage_sequences() or none):
        h, cache = _stage_prefill(sp, h, kind, n, opts, cfg, max_len=max_len,
                                  use_dense=use_dense, emb=emb0,
                                  shared=params.get("shared_attn"),
                                  plan=plan, seq=seq)
        caches.append(cache)
    h = apply_norm(h, params["final_norm"], cfg)
    logits = lm_head(params, h[:, -1:], cfg)[:, 0]
    return logits, caches


# ---------------------------------------------------------------------------
# Stage passes — decode (one token)
# ---------------------------------------------------------------------------


def _cache_at(cache, l):
    """Layer l's cache (KVCache, RWKVState or MambaState; `l` an index or a
    tuple of indices into the stacked axes): views, so the layer's in-place
    writes land in the stage's cache."""
    return type(cache)(*(f[l] for f in cache))


def _stage_decode(sp, h, cache, kind, n, opts, cfg: ModelConfig, *, emb,
                  shared, plan=None, seq=None):
    """`plan` and `seq` as in `_stage_prefill`."""
    if kind in ("rwkv", "mamba"):
        block = B.rwkv_block_decode if kind == "rwkv" \
            else B.mamba_block_decode
        for l in range(n):
            h, _ = block(pshard.gather_tree(layer_slice(sp, l),
                                            layer_slice(plan, l)), h,
                         _cache_at(cache, l), cfg)
        return h
    if kind == "zamba":
        shared_seq = seq["shared"] if seq else None
        for i, (mambas, pls) in enumerate(zip(
                _zamba_blocks(sp, n, opts["every"]),
                _zamba_plans(plan, n, opts["every"]))):
            for j, (lp, pl) in enumerate(zip(mambas, pls)):
                h, _ = B.mamba_block_decode(pshard.gather_tree(lp, pl), h,
                                            _cache_at(cache["mamba"], (i, j)),
                                            cfg)
            with pshard.sequence_parallel(shared_seq):
                h, _ = B.shared_attn_decode(shared, h, emb,
                                            _cache_at(cache["shared"], i),
                                            cfg)
        return h
    if kind == "gemma":
        seq = seq or {"local": None, "global": None}
        for i, ((lps, gp), (lpl, gpl)) in enumerate(zip(
                _gemma_blocks(sp, n, opts["lpg"]),
                _gemma_plans(plan, n, opts["lpg"]))):
            for j, (lp, pl) in enumerate(zip(lps, lpl)):
                with pshard.sequence_parallel(seq["local"]):
                    h, _ = B.decoder_block_decode(
                        pshard.gather_tree(lp, pl), h,
                        _cache_at(cache["local"], (i, j)), cfg,
                        window=cfg.window_size)
            with pshard.sequence_parallel(seq["global"]):
                h, _ = B.decoder_block_decode(pshard.gather_tree(gp, gpl), h,
                                              _cache_at(cache["global"], i),
                                              cfg)
        return h
    for l in range(n):
        with pshard.sequence_parallel(seq):
            h, _ = B.decoder_block_decode(
                pshard.gather_tree(layer_slice(sp, l), layer_slice(plan, l)),
                h, _cache_at(cache, l), cfg, window=opts.get("window"),
                moe=opts["moe"])
    return h


def lm_decode_step(params, cfg: ModelConfig, caches, token, *,
                   embeddings=None):
    """token: [B] int (or embeddings [B, 1, d]). Returns (logits [B, V],
    caches).  CONSUMES `caches`, unlike the reference: every layer's k/v is
    written and its length advanced in place (`attention_decode`), every
    recurrent state overwritten in place (`rwkv_block_decode`,
    `mamba_decode`), and the same cache objects come back.  Clone them first
    to keep a state to return to."""
    h = embed_tokens(params, token[:, None] if token is not None else None,
                     embeddings, cfg)
    emb0 = h
    none = [None] * len(params["stages"])
    for sp, cache, (kind, n, opts), plan, seq in zip(
            params["stages"], caches, lm_stages(cfg),
            pshard.stage_gathers() or none, pshard.stage_sequences() or none):
        h = _stage_decode(sp, h, cache, kind, n, opts, cfg, emb=emb0,
                          shared=params.get("shared_attn"), plan=plan,
                          seq=seq)
    h = apply_norm(h, params["final_norm"], cfg)
    return lm_head(params, h, cfg)[:, 0], caches


# ---------------------------------------------------------------------------
# Cache construction (zeros)
# ---------------------------------------------------------------------------


def init_caches(cfg: ModelConfig, batch: int, max_len: int,
                prefilled: int = 0, device="cuda", ring: str = "min"):
    """The decode caches, zeros, with the sizes `lm_prefill` gives (a
    windowed layer's ring holds min(max_len, window) slots; `ring="window"`:
    `window` slots, as `lm_prefill` leaves it whatever `max_len`), each
    layer's length `prefilled`.  On the card unless `device` says
    otherwise ("meta": the shapes alone)."""
    def kv(lead: tuple, window=None):
        size = (window if ring == "window" else min(max_len, window)) \
            if window else max_len
        shape = lead + (batch, size, cfg.num_kv_heads, cfg.head_dim)
        return KVCache(torch.zeros(shape, dtype=cfg.dtype, device=device),
                       torch.zeros(shape, dtype=cfg.dtype, device=device),
                       torch.full(lead, prefilled, dtype=torch.int32,
                                  device=device))

    def states(st, lead: tuple):  # a zero state per layer
        return type(st)(*(a.new_zeros(lead + tuple(a.shape)) for a in st))

    caches = []
    for kind, n, opts in lm_stages(cfg):
        if kind == "decoder":
            caches.append(kv((n,), opts.get("window")))
        elif kind == "gemma":
            caches.append({"local": kv((n, opts["lpg"]), cfg.window_size),
                           "global": kv((n,))})
        elif kind == "rwkv":
            caches.append(states(init_rwkv_state(cfg, batch, device), (n,)))
        elif kind == "zamba":
            caches.append({"mamba": states(init_mamba_state(cfg, batch,
                                                            device),
                                           (n, opts["every"])),
                           "shared": kv((n,))})
        else:  # mamba
            caches.append(states(init_mamba_state(cfg, batch, device), (n,)))
    return caches
