"""Cost analysis of the ops a program dispatches -- the counterpart of the
reference's `repro.launch.hlo_analysis`, which parses compiled HLO.  Torch
has no HLO: `OpAnalysis` is a `TorchDispatchMode` that sees every aten and
c10d op the program runs (under `FakeTensorMode` too, where nothing is
computed) and fills the reference's `HLOCosts` fields, same names:

  * dot FLOPs        -- the matmul-class ops (mm, addmm, bmm, baddbmm,
                        convolutions, the SDPA ops; einsum dispatches to
                        these), priced by `torch.utils.flop_counter`'s own
                        formulas, so the two agree
  * memory bytes     -- result + operand bytes of every op that
                        materializes: views, creation ops and collectives
                        excluded
  * collective bytes -- result bytes x the reference's COLLECTIVE_FACTOR
                        (all-reduce 2.0, the rest 1.0) of the c10d ops,
                        functional and in-place alike, by op and counted
  * peak live bytes  -- the most bytes the ops' results held at once
                        (storages followed to their release), for the
                        dry-run's `temp_mb`

Eager torch dispatches every iteration of every loop, so there is no
trip-count multiplier (the reference recovers while-loop trip counts from
the HLO); `trip_counts` stays empty.  Elementwise FLOPs are ignored, as in
the reference.
"""
from __future__ import annotations

import dataclasses
import weakref
from typing import Dict, List, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

# bytes moved per device relative to result bytes (ring algorithms)
COLLECTIVE_FACTOR = {"all-gather": 1.0, "all-reduce": 2.0,
                     "reduce-scatter": 1.0, "all-to-all": 1.0,
                     "collective-permute": 1.0}

# c10d op name (functional or in place) -> the reference's HLO opcode
_COLLECTIVES = {
    "all_reduce": "all-reduce", "allreduce_": "all-reduce",
    "allreduce_coalesced_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather", "allgather_": "all-gather",
    "_allgather_base_": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all", "alltoall_": "all-to-all",
    "alltoall_base_": "all-to-all",
    "send": "collective-permute", "recv_": "collective-permute",
}

# ops that move no bytes of their own (creation, metadata-only)
_SKIP_MEM = {"empty", "empty_like", "empty_strided", "zeros", "zeros_like",
             "ones", "ones_like", "full", "full_like", "scalar_tensor",
             "arange", "randn", "rand", "randint", "new_empty",
             "new_empty_strided", "new_zeros", "new_ones", "new_full",
             "lift_fresh", "detach", "wait_tensor", "_local_scalar_dense",
             "_unsafe_view"}


@dataclasses.dataclass
class HLOCosts:
    dot_flops: float = 0.0
    memory_bytes: float = 0.0
    collective_bytes: float = 0.0
    collective_by_op: Dict[str, float] = dataclasses.field(default_factory=dict)
    collective_counts: Dict[str, float] = dataclasses.field(default_factory=dict)
    trip_counts: Dict[str, int] = dataclasses.field(default_factory=dict)
    # populated with breakdown=True: (flops|bytes, descr) tuples
    top_dots: List[Tuple[float, str]] = dataclasses.field(default_factory=list)
    top_memory: List[Tuple[float, str]] = dataclasses.field(default_factory=list)
    top_collectives: List[Tuple[float, str]] = dataclasses.field(
        default_factory=list)
    peak_live_bytes: float = 0.0


def _tensors(tree) -> list:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _shapes(ts) -> str:
    return ", ".join(f"{str(t.dtype).replace('torch.', '')}"
                     f"{list(t.shape)}" for t in ts)


class OpAnalysis(TorchDispatchMode):
    """with OpAnalysis() as oa: ...; oa.costs() -> HLOCosts."""

    def __init__(self, breakdown: bool = False, top_k: int = 20):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self._flops = flop_registry
        self.breakdown, self.top_k = breakdown, top_k
        self.c = HLOCosts(
            collective_by_op={k: 0.0 for k in COLLECTIVE_FACTOR},
            collective_counts={k: 0.0 for k in COLLECTIVE_FACTOR})
        self._dots: list = []
        self._mems: list = []
        self._colls: list = []
        self._live = 0
        self._seen = weakref.WeakKeyDictionary()

    def _release(self, nbytes: int):
        self._live -= nbytes

    def _track(self, outs, ins):
        """Count the new storages of an op's results (not its inputs':
        an in-place op's result is its input)."""
        in_st = [t.untyped_storage() for t in ins]
        for t in outs:
            st = t.untyped_storage()
            if st in self._seen or any(st is x for x in in_st):
                continue
            n = st.nbytes()
            self._seen[st] = n
            self._live += n
            weakref.finalize(st, self._release, n)
        self.c.peak_live_bytes = max(self.c.peak_live_bytes, self._live)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = func._overloadpacket.__name__
        ns = func.namespace
        outs = _tensors(out)
        ins = _tensors((args, kwargs))
        if func._overloadpacket in self._flops:
            f = float(self._flops[func._overloadpacket](
                *args, **kwargs, out_val=out))
            self.c.dot_flops += f
            if self.breakdown:
                self._dots.append((f, f"{func} {_shapes(ins)} -> "
                                      f"{_shapes(outs)}"))
        if ns in ("c10d", "_c10d_functional") and name in _COLLECTIVES:
            op = _COLLECTIVES[name]
            # the result: a functional op's output, an in-place op's first
            # argument (the tensors it writes: the gathered or scattered
            # output, the all-reduced tensors)
            res = outs if ns == "_c10d_functional" else _tensors(args[0])
            b = sum(_nbytes(t) for t in res) * COLLECTIVE_FACTOR[op]
            self.c.collective_bytes += b
            self.c.collective_by_op[op] += b
            self.c.collective_counts[op] += 1
            if self.breakdown:
                self._colls.append((b, f"{func} {_shapes(res)}"))
        elif ns == "aten" and not func.is_view and name not in _SKIP_MEM:
            b = float(sum(_nbytes(t) for t in outs)
                      + sum(_nbytes(t) for t in ins))
            self.c.memory_bytes += b
            if self.breakdown and b > 0:
                self._mems.append((b, f"{func} {_shapes(outs)}"))
        if not func.is_view:
            self._track(outs, ins)
        return out

    def costs(self) -> HLOCosts:
        if self.breakdown:
            k = self.top_k
            self.c.top_dots = sorted(self._dots, reverse=True)[:k]
            self.c.top_memory = sorted(self._mems, reverse=True)[:k]
            self.c.top_collectives = sorted(self._colls, reverse=True)[:k]
        return self.c


def analyze(fn, *args, breakdown: bool = False, top_k: int = 20, **kwargs):
    """(fn's result, HLOCosts of the ops it dispatched)."""
    with OpAnalysis(breakdown=breakdown, top_k=top_k) as oa:
        out = fn(*args, **kwargs)
    return out, oa.costs()
