"""Sharding rules: partition specs for params, inputs and decode caches --
the reference's `repro.launch.sharding`, leaf for leaf, plus the step from
a spec to DTensor placements.

Logical mapping (the reference's):
  * attention heads / FFN hidden / experts / vocab  -> "model"  (TP / EP)
  * batch                                            -> ("pod",) "data"  (DP)
  * large-model parameter dims                       -> "data"   (FSDP/ZeRO-3)
  * decode KV with few kv-heads / batch=1            -> sequence over "model"
    (+ "data" when batch cannot shard) -- flash-decoding split-K layout
  * "pod" axis: pure DP (gradient all-reduce across pods)

Rules are name-based on parameter-tree paths with trailing-dim specs, so the
same table covers stacked layer params ([L, ...], [nb, lpg, ...], ...).

A spec is a `PartitionSpec` (`P`): per tensor dim a mesh axis name, a tuple
of names, or None.  It compares `==` with the reference's `PartitionSpec`
and, like it, normalises a one-name tuple to the name.  `placements` turns a
spec into DTensor placements on a mesh: `Shard(dim)` on every mesh dim the
spec names for that dim, `Replicate()` on the rest; a dim sharded over
("pod", "data") is sharded on both mesh dims in mesh order, which is JAX's
major-to-minor order.  `distribute_tree` places a tree of whole tensors
(the same on every rank) as DTensors by local slicing, with no collective.
"""
from __future__ import annotations

import math
from typing import Any, Optional, Sequence

import torch

from repro_torch.launch.mesh import (axis_names, batch_axes, dp_size,
                                     mesh_shape)
from repro_torch.models.common import ModelConfig
from repro_torch.tree import leaves_with_paths, tree_map, unflatten

# Architectures large enough to need ZeRO-3 parameter sharding over "data".
FSDP_ARCHS = {"chameleon-34b", "deepseek-coder-33b", "qwen3-moe-235b-a22b",
              "dbrx-132b", "deepseek_v32", "rwkv6-7b"}


class PartitionSpec:
    """Per tensor dim: a mesh axis name, a tuple of names, or None.  A
    leaf of the port's trees (not a tuple), so a spec tree has the shape of
    the tree it describes."""
    __slots__ = ("_entries",)

    def __init__(self, *entries):
        def norm(e):
            if isinstance(e, (tuple, list)):
                e = tuple(e)
                return None if not e else (e[0] if len(e) == 1 else e)
            return e
        self._entries = tuple(norm(e) for e in entries)

    def __iter__(self):
        return iter(self._entries)

    def __len__(self):
        return len(self._entries)

    def __getitem__(self, i):
        return self._entries[i]

    def __eq__(self, other):
        if isinstance(other, (str, bytes)) or not hasattr(other, "__iter__"):
            return NotImplemented
        return self._entries == tuple(other)

    def __hash__(self):
        return hash(self._entries)

    def __repr__(self):
        return f"P{self._entries!r}"


P = PartitionSpec


def _path_names(path) -> list:
    return [str(p) for p in path]


def _trailing_spec(names: Sequence[str], ndim: int, fsdp: Optional[str]):
    """Spec for the TRAILING dims by leaf name; leading stack dims -> None."""
    name = names[-1]
    parents = set(names)
    M, F = "model", fsdp

    def pad(spec):
        spec = tuple(spec)
        assert len(spec) <= ndim, (names, ndim, spec)
        return P(*((None,) * (ndim - len(spec)) + spec))

    # ---- embeddings / heads
    if name == "embed":
        return pad((M, None))
    if name == "lm_head":
        return pad((None, M))
    # ---- MoE experts (leading per-layer dims handled by pad)
    if "experts" in parents:
        if name in ("w_gate", "w_up"):
            return pad((M, F, None))
        if name == "w_down":
            return pad((M, None, F))
    if name == "router":
        return pad((None, None))
    # ---- channel-mix (RWKV) before generic wk/wv/wr
    if "channel_mix" in parents:
        if name == "wk":
            return pad((F, M))
        if name == "wv":
            return pad((M, F))
        if name == "wr":
            return pad((F, None))
        return pad((None,))
    # ---- attention / time-mix projections
    if name in ("wq", "wk", "wv", "wg", "wr"):
        return pad((F, M))
    if name == "wo":
        return pad((M, F))
    if name in ("bq", "bk", "bv"):
        return pad((M,))
    # ---- dense FFN (incl. shared experts, shared attention block)
    if name in ("w_gate", "w_up"):
        return pad((F, M))
    if name == "w_down":
        return pad((M, F))
    # ---- mamba
    if name == "in_proj":
        return pad((F, M))
    if name == "out_proj":
        return pad((M, F))
    if name == "conv_w":
        return pad((None, M))
    if name in ("conv_b", "out_norm"):
        return pad((M,))
    # ---- rwkv lora
    if name == "w_lora_a":
        return pad((F, None))
    if name == "w_lora_b":
        return pad((None, M))
    # ---- everything else (norms, biases, mus, decay params): replicate
    return P(*((None,) * ndim))


def _axes(entry) -> tuple:
    return entry if isinstance(entry, tuple) else (entry,)


def _axis_size(mesh, ax) -> int:
    shape = mesh_shape(mesh)
    return math.prod(shape[a] for a in _axes(ax))


def _validate_spec(spec: P, shape, mesh) -> P:
    """Drop mesh axes whose size does not divide the dim (e.g. seamless's
    256206 vocab vs model=16): a shard is always an exact chunk."""
    out = []
    for i, ax in enumerate(tuple(spec)):
        if ax is None or i >= len(shape):
            out.append(None)
            continue
        out.append(ax if shape[i] % _axis_size(mesh, ax) == 0 else None)
    return P(*out)


def param_specs(params, cfg: ModelConfig, mesh) -> Any:
    fsdp = "data" if (cfg.name in FSDP_ARCHS and "data" in axis_names(mesh)
                      and not cfg.no_fsdp) else None
    specs = [_validate_spec(
        _trailing_spec(_path_names(path), leaf.dim(), fsdp),
        tuple(leaf.shape), mesh)
        for path, leaf in leaves_with_paths(params)]
    return unflatten(params, specs)


_HEAD_LEAVES = {"wq": "q", "bq": "q", "wo": "q",
                "wk": "kv", "bk": "kv", "wv": "kv", "bv": "kv"}
_TIME_MIX_LEAVES = ("wr", "wk", "wv", "wg", "wo", "w_lora_b")
_MAMBA_LEAVES = ("in_proj", "conv_w", "conv_b", "out_norm", "out_proj")


def rwkv_splits(cfg: ModelConfig, model: int) -> bool:
    """Whether RWKV's time mix computes over "model": its wkv heads split
    into whole heads (as `cache_specs` splits the wkv state)."""
    return (cfg.d_model // cfg.ssm_head_dim) % model == 0


def mamba_splits(cfg: ModelConfig, model: int) -> bool:
    """Whether a Mamba2 mixer computes over "model": its SSD heads split
    into whole heads and its conv channels (x, B, C) into equal chunks (as
    `cache_specs` splits the ssm state and the conv ring)."""
    d_inner = cfg.ssm_expand * cfg.d_model
    heads = d_inner // cfg.ssm_head_dim
    return heads % model == 0 and (d_inner + 2 * cfg.ssm_state) % model == 0


def _computes_over_model(names: Sequence[str], cfg: ModelConfig,
                         model: int) -> bool:
    """Whether the model code computes this leaf on a "model" shard: whole
    heads of attention (self, encoder and cross: q heads for wq / bq / wo,
    kv heads for wk / wv / bk / bv, the kv side only where the q side is
    sharded too) and of RWKV's time mix (`rwkv_splits`); a Mamba2 mixer's
    projection columns, conv channels and inner channels where its heads
    split (`mamba_splits`); and the FFN hidden columns (RWKV's channel mix
    too), experts and vocab rows the spec's divisibility already makes
    whole.  Anything else is gathered over "model" -- among them zamba's
    shared `in_proj` [2d, d], whose output is the residual."""
    name, parents = names[-1], set(names[:-1])
    if "time_mix" in parents:
        return name in _TIME_MIX_LEAVES and rwkv_splits(cfg, model)
    if "channel_mix" in parents:
        return name in ("wk", "wv")
    if "mamba" in parents:
        return name in _MAMBA_LEAVES and mamba_splits(cfg, model)
    if name in _HEAD_LEAVES and parents & {"attn", "cross"}:
        if cfg.num_heads % model:
            return False
        return _HEAD_LEAVES[name] == "q" or cfg.num_kv_heads % model == 0
    if name in ("embed", "lm_head"):
        return True
    return name in ("w_gate", "w_up", "w_down") and (
        "ffn" in parents or "experts" in parents or "shared" in parents)


def compute_specs(params, cfg: ModelConfig, mesh) -> Any:
    """The spec each leaf is COMPUTED with in the mesh step: its
    `param_specs` entry with every batch axis dropped (the step gathers it
    over them, a stacked layer's inside the layer) and "model" kept only
    where the model code computes on whole units of it
    (`_computes_over_model`); elsewhere the leaf is gathered over "model"
    too.  Storage stays `param_specs`."""
    return compute_specs_of(param_specs(params, cfg, mesh), cfg, mesh)


def compute_specs_of(pspecs, cfg: ModelConfig, mesh) -> Any:
    """`compute_specs` from the param specs' tree (the leaves' paths are
    all the rule reads)."""
    model = mesh_shape(mesh).get("model", 1)

    def spec(path, stored):
        keep = _computes_over_model(_path_names(path), cfg, model)
        return P(*("model" if keep and e is not None and "model" in _axes(e)
                   else None for e in stored))

    return unflatten(pspecs, [spec(path, s)
                              for path, s in leaves_with_paths(pspecs)])


# ---------------------------------------------------------------------------
# Inputs
# ---------------------------------------------------------------------------


def batch_specs(batch: dict, mesh) -> dict:
    """Specs for a batch dict (tokens/labels/embeddings/token)."""
    ba = batch_axes(mesh)
    dp = dp_size(mesh)

    def spec(leaf):
        b = leaf.shape[0] if leaf.dim() else 1
        lead = ba if b % dp == 0 else None
        return _validate_spec(P(lead, *((None,) * (leaf.dim() - 1))),
                              tuple(leaf.shape), mesh)

    return {k: spec(v) for k, v in batch.items()}


# ---------------------------------------------------------------------------
# Decode caches
# ---------------------------------------------------------------------------


def _kv_spec(ndim: int, batch: int, kvh: int, mesh) -> P:
    """KVCache k/v: [*lead, B, S, kvh, hd]."""
    ba = batch_axes(mesh)
    dp = dp_size(mesh)
    model_n = mesh_shape(mesh)["model"]
    lead = (None,) * (ndim - 4)
    if batch % dp == 0 and batch >= dp:
        b_ax: Any = ba
        seq_ax = "model" if kvh < model_n else None
        head_ax = "model" if kvh >= model_n else None
    else:
        # batch too small (long-context decode): sequence over everything
        b_ax = None
        seq_ax = ba + ("model",) if kvh < model_n else ba
        head_ax = "model" if kvh >= model_n else None
    return P(*lead, b_ax, seq_ax, head_ax, None)


def cache_specs(caches, cfg: ModelConfig, batch: int, mesh) -> Any:
    """Spec tree matching `api.make_caches` (the typed nodes KVCache /
    MambaState / RWKVState, lists and tuples of them, encoder memory)."""
    from repro_torch.models.attention import KVCache
    from repro_torch.models.mamba2 import MambaState
    from repro_torch.models.rwkv6 import RWKVState

    ba = batch_axes(mesh)
    dp = dp_size(mesh)
    model_n = mesh_shape(mesh)["model"]
    b_ax: Any = ba if (batch % dp == 0 and batch >= dp) else None

    def state_spec(shape, nd):
        """[*, B, H, ...]: batch over data if possible, heads over model."""
        lead = (None,) * (nd - 4)
        h_ax = "model" if shape[-3] % model_n == 0 else None
        return P(*lead, b_ax, h_ax, None, None)

    def walk(node):
        if isinstance(node, KVCache):
            kv = _kv_spec(node.k.dim(), batch, node.k.shape[-2], mesh)
            return KVCache(kv, kv, P(*((None,) * node.length.dim())))
        if isinstance(node, MambaState):
            nd_c = node.conv.dim()
            c_ax = "model" if node.conv.shape[-1] % model_n == 0 else None
            return MambaState(
                state_spec(tuple(node.ssm.shape), node.ssm.dim()),
                P(*((None,) * (nd_c - 3)), b_ax, None, c_ax))
        if isinstance(node, RWKVState):
            sh = P(*((None,) * (node.shift_tm.dim() - 2)), b_ax, None)
            return RWKVState(
                state_spec(tuple(node.wkv.shape), node.wkv.dim()), sh, sh)
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v) for v in node)
        # plain tensor leaf (e.g. enc-dec memory [B, S_enc, d])
        nd = node.dim()
        if nd >= 2:
            return P(b_ax, *((None,) * (nd - 1)))
        return P(*((None,) * nd))

    return tree_map(lambda leaf, spec: _validate_spec(spec, tuple(leaf.shape),
                                                      mesh), caches,
                    walk(caches))


def kv_seq_shard(spec: P, mesh, slots: int, whole: bool):
    """The `pshard.SeqShard` of a KV leaf [*lead, B, S, kvh, hd] stored
    under `spec` (its validated `cache_specs` entry: any axis that did not
    divide its dim is already dropped, so heads and sequence may both be
    sharded, or neither), at this rank's mesh coordinate; None where the
    sequence is whole.  `slots`: the leaf's S, whole (`whole`) or this
    rank's shard's.  The kv heads split over "model" or not at all."""
    from repro_torch.models.pshard import SeqShard
    names, sizes = axis_names(mesh), mesh_shape(mesh)
    seq, heads = spec[-3], spec[-2]
    if heads not in (None, "model"):
        raise ValueError(f"{spec}: kv heads sharded over {heads!r}")
    live = [a for a in (_axes(seq) if seq is not None else ())
            if sizes[a] > 1]  # major to minor
    if not live:
        return None
    coord, index = mesh.get_coordinate(), 0
    for a in live:
        index = index * sizes[a] + coord[names.index(a)]
    count = math.prod(sizes[a] for a in live)
    local = slots // count if whole else slots
    return SeqShard(tuple(mesh.get_group(names.index(a)) for a in live),
                    tuple(sizes[a] for a in live), index * local,
                    "model" in live)


def dispatch_groups_for(mesh, tokens: int) -> int:
    """MoE dispatch groups = DP size when it divides the token count."""
    g = math.gcd(dp_size(mesh), tokens)
    return g if g > 1 else 1


# ---------------------------------------------------------------------------
# Specs as DTensor placements
# ---------------------------------------------------------------------------


def placements(spec: P, mesh) -> list:
    """DTensor placements of `spec` on `mesh`, one per mesh dim."""
    from torch.distributed.tensor import Replicate, Shard
    names = axis_names(mesh)
    out: list = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        idx = [names.index(a) for a in _axes(entry)]
        if idx != sorted(idx):
            raise ValueError(f"{spec}: the axes of dim {dim} must follow the "
                             f"mesh order {names}")
        for i in idx:
            out[i] = Shard(dim)
    return out


def shard_slices(spec: P, shape, mesh, coord: Sequence[int]) -> list:
    """[(dim, start, length)] of the shard at mesh coordinate `coord`."""
    names = axis_names(mesh)
    sizes = mesh_shape(mesh)
    out = []
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        n, idx = 1, 0
        for a in _axes(entry):  # major to minor
            n *= sizes[a]
            idx = idx * sizes[a] + coord[names.index(a)]
        size = shape[dim] // n
        out.append((dim, idx * size, size))
    return out


def local_shard(t: torch.Tensor, spec: P, mesh) -> torch.Tensor:
    """This rank's shard of the whole tensor `t` under `spec` (a view)."""
    coord = mesh.get_coordinate()
    for dim, start, size in shard_slices(spec, tuple(t.shape), mesh, coord):
        t = t.narrow(dim, start, size)
    return t


def distribute(t: torch.Tensor, mesh, spec: P):
    """`t` (whole, the same on every rank) as a DTensor under `spec`: each
    rank keeps its own slice (copied; `t` itself where nothing shards)."""
    from torch.distributed.tensor import DTensor
    local = local_shard(t, spec, mesh)
    if local.shape != t.shape:
        local = local.clone(memory_format=torch.contiguous_format)
    # the shards are exact chunks (_validate_spec): from_local infers the
    # whole shape
    return DTensor.from_local(local, mesh, placements(spec, mesh),
                              run_check=False)


def distribute_tree(tree, mesh, specs):
    return tree_map(lambda t, s: distribute(t, mesh, s), tree, specs)


def full_tree(tree):
    """DTensor leaves gathered to their whole value (a collective: every
    rank of their mesh calls it); other leaves as they are."""
    from torch.distributed.tensor import DTensor
    return tree_map(lambda t: t.full_tensor() if isinstance(t, DTensor)
                    else t, tree)
