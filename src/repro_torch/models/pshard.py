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
"""
from __future__ import annotations

from contextlib import contextmanager
from typing import Any, Dict, Optional

import torch

_RULES: Dict[str, Any] = {}
_DP: Optional[tuple] = None  # (process groups, size) inside data_parallel

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
