"""Logical-axis sharding hints for model internals -- the reference's
`repro.models.pshard` -- and the batch statistics of a data-parallel step.

`constrain(x, "batch", None, "heads", None)` maps logical names to mesh
axes through module-level rules.  It returns `x` unchanged when no rules
are set (the tests, one device), when no name maps, and for a plain tensor;
a DTensor it redistributes to the mapped placements on its own mesh, the
counterpart of `with_sharding_constraint`.  Set by the launcher or the
dry-run before a step:

    pshard.set_rules(batch=("data",), experts="model", moe_rows="data")

`data_parallel(groups, size)` marks the span of a data-parallel step whose
ranks each hold one equal shard of the batch: inside it, the model's
batch-global statistics that are not linear in the tokens (the MoE router's
load-balance fractions) are averaged over the process groups of the batch
axes with `all_reduce_mean`, which autograd differentiates.  Outside it
(one device) nothing changes.

`model_parallel(group, size, rank)` marks the span of a step whose ranks of
one data row compute over the `"model"` axis (tensor / expert parallel, the
compute GSPMD partitions by the param specs).  The model then computes on
the local shards it is handed (heads, channels, FFN columns, experts, vocab
rows, read off the leaves' shapes) and crosses ranks only through the four
operators of Megatron-style TP and two more, each an autograd Function:

  copy_to_model      forward identity,        backward all-reduce
  reduce_from_model  forward all-reduce,      backward identity
  scatter_to_model   forward the local slice, backward all-gather
  gather_from_model  forward all-gather,      backward the local slice
  gather_to_model    forward all-gather,      backward all-reduce, local slice
  sum_over_model     forward all-reduce,      backward all-reduce

The loss is the same on every rank of the group, so a reduction's backward
is the identity and a slice's an all-gather, where what follows is computed
the same on every rank.  Where it is not -- each rank reads its own part of
a whole tensor (Mamba's projection, gathered, read for the rank's heads),
or normalises its own channels by a statistic summed over all of them --
each rank holds a partial gradient, and `gather_to_model` / `sum_over_model`
sum those in their backward.  Outside the context, or at size 1, every
operator is the identity.

`sequence_parallel(shard)` marks one layer's attention in a mesh serving
step whose KV cache is split over the sequence (flash-decoding split-K):
`shard` (a `SeqShard`) holds the groups and sizes of the axes that split
it and the rank's first slot; `seq_max` / `seq_sum` reduce plain tensors
over those groups, axis by axis (no autograd: serving only).  The steps
hand the LM core a `SeqShard` per KV cache and stage through
`sequence_plans(plans)` / `stage_sequences()`.

`gathered(plans)` hands the model the per-layer gathers of a mesh step:
`stage_gathers()` is, per stage, a tree of `LeafGather`s shaped like the
stage's params; the LM core applies a layer's inside the (rematerialized)
layer body (`gather_tree`), so no gathered layer outlives its use.  A
`LeafGather` turns a stored shard into the tensor the step computes with
(all-gathers over the axes the compute spec drops) and its backward turns
the gradient into the stored shard's, already summed over the batch axes
and divided by their size.
"""
from __future__ import annotations

import math
from contextlib import contextmanager
from typing import Any, Dict, NamedTuple, Optional

import torch

_RULES: Dict[str, Any] = {}
_DP: Optional[tuple] = None  # (process groups, size) inside data_parallel
_MP: Optional[tuple] = None  # (process group, size, rank) in model_parallel
_GATHERS: Optional[list] = None  # per stage, a tree of LeafGathers
#: bytes of the tensors the per-layer gathers made since the last
#: `reset_gather_bytes()`: "gather", the forward's gathered params;
#: "reduce", the backward's gradient shards
GATHER_BYTES = {"gather": 0, "reduce": 0}

#: every logical axis name the model code may pass to `constrain` -- the
#: universe shardcheck (sc-unknown-logical-axis) validates call sites
#: against, and set_rules validates rule keys against.  A name outside this
#: set would be a silent no-op: no constrain site could ever consume it.
KNOWN_LOGICAL_AXES = frozenset({
    "batch", "heads", "experts", "moe_group", "moe_rows", "moe_tokens",
})


def set_rules(**rules):
    global _RULES
    unknown = sorted(set(rules) - KNOWN_LOGICAL_AXES)
    if unknown:
        raise ValueError(
            f"pshard.set_rules: unknown logical axis name(s) {unknown} -- "
            f"known axes are {sorted(KNOWN_LOGICAL_AXES)}; a rule for an "
            f"unknown name would silently never apply")
    _RULES = dict(rules)


def clear_rules():
    global _RULES
    _RULES = {}


def get_rules() -> Dict[str, Any]:
    return dict(_RULES)


@contextmanager
def rules(**r):
    old = get_rules()
    set_rules(**r)
    try:
        yield
    finally:
        set_rules(**old)


def constrain(x: torch.Tensor, *names: Optional[str]) -> torch.Tensor:
    if not _RULES:
        return x
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    axes = [_RULES.get(n) if n else None for n in names]
    if all(a is None for a in axes):
        return x
    from repro_torch.launch.mesh import mesh_shape
    from repro_torch.launch.sharding import P, placements
    sizes = mesh_shape(x.device_mesh)

    def ok(dim, ax):
        # drop axes whose size doesn't divide the dim (launch.sharding's rule)
        if ax is None:
            return None
        n = 1
        for a in (ax if isinstance(ax, tuple) else (ax,)):
            n *= sizes.get(a, 1)
        return ax if (n > 1 and dim % n == 0) else None

    spec = P(*[ok(d, a) for d, a in zip(x.shape, axes)])
    if all(s is None for s in spec):
        return x
    return x.redistribute(x.device_mesh, placements(spec, x.device_mesh))


# ---------------------------------------------------------------------------
# Batch statistics over the data-parallel group
# ---------------------------------------------------------------------------


@contextmanager
def data_parallel(groups, size: int):
    global _DP
    old, _DP = _DP, (list(groups), size)
    try:
        yield
    finally:
        _DP = old


def data_parallel_size() -> int:
    return _DP[1] if _DP is not None else 1


class _AllReduceSum(torch.autograd.Function):
    """Sum over process groups, one after the other; the gradient is summed
    the same way (every rank's loss holds the global statistic, and the
    step averages the ranks' gradients)."""

    @staticmethod
    def forward(ctx, x, groups):
        ctx.groups = groups
        return _sum_over(x.clone(), groups)

    @staticmethod
    def backward(ctx, g):
        return _sum_over(g.clone(), ctx.groups), None


def _sum_over(t: torch.Tensor, groups) -> torch.Tensor:
    import torch.distributed as dist
    for group in groups:
        dist.all_reduce(t, group=group)
    return t


def all_reduce_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean of `x` over the data-parallel group (`x` itself outside
    `data_parallel`)."""
    if _DP is None:
        return x
    groups, size = _DP
    return _AllReduceSum.apply(x, groups) / size


# ---------------------------------------------------------------------------
# Tensor / expert parallelism over "model"
# ---------------------------------------------------------------------------


@contextmanager
def model_parallel(group, size: int, rank: int):
    global _MP
    old, _MP = _MP, (group, size, rank)
    try:
        yield
    finally:
        _MP = old


def model_parallel_size() -> int:
    return _MP[1] if _MP is not None else 1


def model_parallel_rank() -> int:
    return _MP[2] if _MP is not None else 0


def _tp():
    """The model group, or None where the operators are the identity."""
    return _MP[0] if _MP is not None and _MP[1] > 1 else None


def _all_gather(t: torch.Tensor, dim: int, group, size: int) -> torch.Tensor:
    """`t`'s shards of every rank of `group`, concatenated along `dim` in
    rank order (the list form: gloo has it on CUDA tensors too)."""
    import torch.distributed as dist
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(size)]
    dist.all_gather(parts, t, group=group)
    return torch.cat(parts, dim)


def _reduce_scatter(t: torch.Tensor, dim: int, group,
                    size: int) -> torch.Tensor:
    """This rank's chunk along `dim` of the sum of `t` over `group`."""
    import torch.distributed as dist
    # newer torch deprecates reduce_scatter_tensor for reduce_scatter_single
    rs = getattr(dist, "reduce_scatter_single", None) \
        or dist.reduce_scatter_tensor
    src = t.movedim(dim, 0).contiguous()
    out = src.new_empty((src.shape[0] // size,) + tuple(src.shape[1:]))
    rs(out, src, group=group)
    return out.movedim(0, dim)


def _chunk(t: torch.Tensor, dim: int, size: int, rank: int) -> torch.Tensor:
    n = t.shape[dim] // size
    return t.narrow(dim, rank * n, n)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _sum_over(g.clone(), [ctx.group]), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _sum_over(x.clone(), [group])

    @staticmethod
    def backward(ctx, g):
        return g, None


class _ScatterToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group, size, rank):
        ctx.args = (dim, group, size)
        return _chunk(x, dim, size, rank).contiguous()

    @staticmethod
    def backward(ctx, g):
        return (_all_gather(g, *ctx.args),) + (None,) * 4


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group, size, rank):
        ctx.args = (dim, size, rank)
        return _all_gather(x, dim, group, size)

    @staticmethod
    def backward(ctx, g):
        return (_chunk(g, *ctx.args).contiguous(),) + (None,) * 4


def copy_to_model(x: torch.Tensor) -> torch.Tensor:
    """Enters a parallel region: `x` replicated over "model" is used on
    local shards, so its gradient is summed over the group."""
    group = _tp()
    return x if group is None else _CopyToModel.apply(x, group)


def reduce_from_model(x: torch.Tensor) -> torch.Tensor:
    """Leaves a parallel region: the ranks' partial sums added."""
    group = _tp()
    return x if group is None else _ReduceFromModel.apply(x, group)


def scatter_to_model(x: torch.Tensor, dim: int) -> torch.Tensor:
    """This rank's chunk along `dim` of `x` replicated over "model"."""
    group = _tp()
    if group is None:
        return x
    return _ScatterToModel.apply(x, dim, group, _MP[1], _MP[2])


def gather_from_model(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The ranks' chunks along `dim` concatenated, in rank order."""
    group = _tp()
    if group is None:
        return x
    return _GatherFromModel.apply(x, dim, group, _MP[1], _MP[2])


def gather_to_model(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The ranks' chunks along `dim` concatenated, for a use that differs
    by rank (each reads its own part of the whole, and parts every rank
    reads): the ranks' partial gradients are summed before the local
    chunk is taken."""
    return copy_to_model(gather_from_model(x, dim))


def sum_over_model(x: torch.Tensor) -> torch.Tensor:
    """The sum over "model" of per-rank partial statistics that every rank
    then uses on its own shard (a norm's sum of squares over channels split
    over "model"): each rank's gradient of the sum is partial, so the
    backward sums too."""
    group = _tp()
    return x if group is None else _AllReduceSum.apply(x, [group])


def max_over_model(x: torch.Tensor) -> torch.Tensor:
    """Elementwise max over "model" of a tensor no gradient flows through
    (the cross entropy's shift)."""
    import torch.distributed as dist
    group = _tp()
    if group is None:
        return x
    x = x.detach().clone()
    dist.all_reduce(x, op=dist.ReduceOp.MAX, group=group)
    return x


# ---------------------------------------------------------------------------
# The sequence of a sharded KV cache (serving over a mesh)
# ---------------------------------------------------------------------------


class SeqShard(NamedTuple):
    """This rank's share of a KV cache's sequence in a mesh serving step:
    `groups` / `sizes` the process groups and sizes of the mesh axes that
    shard it (major to minor; axes of size 1 left out), `offset` the first
    global slot of the rank's shard, `model` whether "model" is one of the
    axes (its ranks then hold different slots of the same heads)."""
    groups: tuple
    sizes: tuple
    offset: int
    model: bool

    @property
    def count(self) -> int:
        """The number of shards of the sequence."""
        return math.prod(self.sizes)


_SP: Optional[SeqShard] = None  # inside sequence_parallel
_SEQ: Optional[list] = None  # per stage, a tree of SeqShards (or None)


@contextmanager
def sequence_parallel(shard: Optional[SeqShard]):
    """Marks the span of one layer's attention whose KV cache is split over
    the sequence (flash-decoding split-K); `shard` None leaves it whole."""
    global _SP
    old, _SP = _SP, shard
    try:
        yield
    finally:
        _SP = old


def sequence_shard() -> Optional[SeqShard]:
    return _SP


def _seq_reduce(x: torch.Tensor, op) -> torch.Tensor:
    import torch.distributed as dist
    x = x.contiguous().clone()
    for group in _SP.groups:  # axis by axis
        dist.all_reduce(x, op=op, group=group)
    return x


def seq_max(x: torch.Tensor) -> torch.Tensor:
    """Elementwise max of `x` over the ranks sharing the sequence (`x`
    itself outside `sequence_parallel`).  Plain tensors: the serving
    steps run no autograd, so neither reduction has a backward."""
    import torch.distributed as dist
    return x if _SP is None else _seq_reduce(x, dist.ReduceOp.MAX)


def seq_sum(x: torch.Tensor) -> torch.Tensor:
    """Elementwise sum of `x` over the ranks sharing the sequence (`x`
    itself outside `sequence_parallel`); no backward, as `seq_max`."""
    import torch.distributed as dist
    return x if _SP is None else _seq_reduce(x, dist.ReduceOp.SUM)


@contextmanager
def sequence_plans(plans: Optional[list]):
    """Hands the LM core, per stage, a tree shaped like the stage's caches
    with a SeqShard (or None) in place of each KVCache: the mesh serving
    steps' layouts (`launch.steps`)."""
    global _SEQ
    old, _SEQ = _SEQ, plans
    try:
        yield
    finally:
        _SEQ = old


def stage_sequences() -> Optional[list]:
    return _SEQ


# ---------------------------------------------------------------------------
# Per-layer gathering of a mesh step's params
# ---------------------------------------------------------------------------


class LeafGather:
    """From one leaf's stored shard to the tensor the step computes with.

    `steps`: (dim, group, size, rank, over_batch) in the order the forward
    all-gathers them (each along one dim; a dim sharded over several axes
    minor axis first); `reduce`: the batch axes' groups that shard no dim,
    over which the backward all-reduces; `dp`: the batch axes' size, the
    backward's divisor.  Indexing drops leading (stacked layer) dims, so a
    stage's tree of LeafGathers slices like its params (`lm.layer_slice`).
    `model_sharded`: whether the computed tensor is a shard over "model"."""
    __slots__ = ("steps", "reduce", "dp", "model_sharded")

    def __init__(self, steps, reduce, dp: int, model_sharded: bool):
        self.steps, self.reduce, self.dp = tuple(steps), tuple(reduce), dp
        self.model_sharded = model_sharded

    def __getitem__(self, idx) -> "LeafGather":
        n = len(idx) if isinstance(idx, tuple) else 1
        if any(s[0] < n for s in self.steps):
            raise IndexError("a stacked layer dim is sharded")
        return LeafGather([(s[0] - n,) + s[1:] for s in self.steps],
                          self.reduce, self.dp, self.model_sharded)

    @property
    def identity(self) -> bool:
        return not self.steps and not self.reduce and self.dp == 1

    def __call__(self, t: torch.Tensor) -> torch.Tensor:
        return t if self.identity else _GatherParam.apply(t, self)


class _GatherParam(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, lg: LeafGather):
        ctx.lg = lg
        for dim, group, size, _, _ in lg.steps:
            t = _all_gather(t, dim, group, size)
        if lg.steps:
            GATHER_BYTES["gather"] += t.numel() * t.element_size()
        return t

    @staticmethod
    def backward(ctx, g):
        lg = ctx.lg
        fresh = False  # g a tensor of this backward's own, not autograd's
        for dim, group, size, rank, over_batch in reversed(lg.steps):
            if over_batch:  # summed over the batch shards' gradients
                g = _reduce_scatter(g, dim, group, size)
                fresh = True
            else:  # the same full gradient on every model rank
                g = _chunk(g, dim, size, rank)
        if lg.reduce:
            g = _sum_over(g.contiguous() if fresh else
                          g.clone(memory_format=torch.contiguous_format),
                          lg.reduce)
        else:
            g = g.contiguous()
        g = g / lg.dp if lg.dp > 1 else g
        GATHER_BYTES["reduce"] += g.numel() * g.element_size()
        return g, None


def reset_gather_bytes() -> dict:
    """GATHER_BYTES as it stood, then both counts set to 0."""
    out = dict(GATHER_BYTES)
    GATHER_BYTES.update(gather=0, reduce=0)
    return out


def gather_tree(tree, plan):
    """`tree` (one layer's params, or a whole subtree) with each leaf through
    its LeafGather in `plan` (a tree of the same shape); `tree` itself
    without a plan."""
    if plan is None:
        return tree
    if isinstance(tree, dict):
        return {k: gather_tree(v, plan[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(gather_tree(v, p) for v, p in zip(tree, plan))
    return None if tree is None else plan(tree)


@contextmanager
def gathered(plans: list):
    global _GATHERS
    old, _GATHERS = _GATHERS, plans
    try:
        yield
    finally:
        _GATHERS = old


def stage_gathers() -> Optional[list]:
    """Per stage of the LM, the tree of LeafGathers of its stacked params
    (None outside a mesh step that gathers per layer)."""
    return _GATHERS
