"""Cost contracts -- a perf-regression tripwire that needs no card, the
counterpart of the reference's HLO cost contracts.

For a small pinned set of (arch, step) cells, build the port's real step on
a fake 8-rank (2 data x 4 model) mesh -- `launch.dryrun`'s fake process
group and fake tensors --, record rank 0's ops with `launch.op_analysis`,
and diff dot-FLOPs / collective-bytes / memory-bytes against checked-in
golden JSON with a relative tolerance band.  A change that silently
inflates communication volume or FLOPs (a dropped sharding rule, an
accidental gather, a duplicated matmul) fails here.

The goldens are the port's own (`contracts_golden/` beside this module):
the port's program (eager ops and explicit collectives: the train and
prefill cells' tensor- and expert-parallel steps, each layer gathered over
the batch axes inside the layer) is not the reference's GSPMD HLO, so its
numbers are not held to the reference's.
They are deterministic for a given torch: the gate compares counts of the
dispatched ops, not wall-clock.

    python -m repro_torch.analysis --contracts          # verify
    python -m repro_torch.analysis --update-contracts   # re-baseline

The fake process group is process-global: the CLI runs in a process of its
own, and so do the tests that measure.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, List, Optional, Tuple

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "contracts_golden")

#: relative tolerance band: |measured - golden| / golden must stay under
#: this for every metric.
RTOL = 0.02

MESH_SHAPE = (2, 4)  # (data, model) over 8 fake ranks
MESH_AXES = ("data", "model")

METRICS = ("dot_flops", "collective_bytes", "memory_bytes")


@dataclasses.dataclass(frozen=True)
class ContractSpec:
    name: str
    arch: str
    kind: str  # "train" | "prefill"
    batch: int = 8
    seq: int = 64
    layers: int = 2


#: the pinned contract cells: the MoE prefill path (the paper's subject),
#: the MoE train path (adds the optimizer + gradient collectives), and a
#: dense control (catches regressions that MoE noise could mask).
CONTRACTS = (
    ContractSpec("moe_train", "qwen3_moe_235b_a22b", "train"),
    ContractSpec("moe_prefill", "qwen3_moe_235b_a22b", "prefill"),
    ContractSpec("dense_train", "gemma3_1b", "train"),
)


def golden_path(name: str) -> str:
    return os.path.join(GOLDEN_DIR, f"{name}.json")


def load_golden(name: str) -> Optional[dict]:
    path = golden_path(name)
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def save_golden(name: str, record: dict):
    os.makedirs(GOLDEN_DIR, exist_ok=True)
    with open(golden_path(name), "w") as f:
        json.dump(record, f, indent=2, sort_keys=True)
        f.write("\n")


def diff_metrics(golden: Dict[str, float], measured: Dict[str, float],
                 rtol: float = RTOL) -> List[dict]:
    """Violations of the tolerance band (a pure function).  Both directions
    fail: inflation is a regression, deflation means the golden is stale --
    re-baseline deliberately with --update-contracts."""
    out = []
    for metric in METRICS:
        g, m = golden.get(metric), measured.get(metric)
        if g is None or m is None:
            out.append(dict(metric=metric, golden=g, measured=m,
                            rel=None, why="metric missing"))
            continue
        rel = (m - g) / g if g else (0.0 if m == g else float("inf"))
        if abs(rel) > rtol:
            why = "inflated" if rel > 0 else "deflated"
            out.append(dict(metric=metric, golden=g, measured=m,
                            rel=round(rel, 6), why=why))
    return out


# ---------------------------------------------------------------------------
# measurement (joins a fake process group: its own process)
# ---------------------------------------------------------------------------


def _make_mesh():
    from repro_torch.launch.dryrun import fake_world
    from repro_torch.launch.mesh import _device_mesh
    fake_world(MESH_SHAPE[0] * MESH_SHAPE[1])
    return _device_mesh("cpu", MESH_SHAPE, MESH_AXES)


def measure(spec: ContractSpec, mesh=None) -> Dict[str, float]:
    """Rank 0's op_analysis metrics of the contract cell's step."""
    from repro_torch.configs import get_config
    from repro_torch.launch import sharding as SH
    from repro_torch.launch.dryrun import _fake_mode, build_step
    from repro_torch.launch.op_analysis import OpAnalysis

    if mesh is None:
        mesh = _make_mesh()
    B, S = spec.batch, spec.seq
    cfg = get_config(spec.arch).smoke().replace(num_layers=spec.layers)
    if cfg.num_experts:
        tokens = B * S if spec.kind == "train" else B
        cfg = cfg.replace(
            num_experts=4, top_k=2,
            dispatch_groups=SH.dispatch_groups_for(mesh, tokens))
    if spec.kind not in ("train", "prefill"):
        raise ValueError(f"unknown contract kind {spec.kind!r}")
    with _fake_mode():
        fn, args, _ = build_step(cfg, spec.kind, B, S, mesh)
        with OpAnalysis() as oa:
            fn(*args)
    hc = oa.costs()
    return {
        "dot_flops": float(hc.dot_flops),
        "collective_bytes": float(hc.collective_bytes),
        "memory_bytes": float(hc.memory_bytes),
        "collective_by_op": {k: float(v)
                             for k, v in hc.collective_by_op.items() if v},
    }


def run_contracts(update: bool = False,
                  rtol: float = RTOL) -> Tuple[bool, dict]:
    """Verify (or re-baseline) every pinned contract.

    Returns (ok, report); report["contracts"] holds one entry per cell with
    status "ok" | "fail" | "missing-golden" | "updated"."""
    mesh = _make_mesh()
    entries = []
    ok = True
    for spec in CONTRACTS:
        measured = measure(spec, mesh)
        entry = dict(name=spec.name, arch=spec.arch, kind=spec.kind,
                     mesh=list(MESH_SHAPE), measured=measured)
        if update:
            save_golden(spec.name, dict(
                name=spec.name, arch=spec.arch, kind=spec.kind,
                batch=spec.batch, seq=spec.seq, layers=spec.layers,
                mesh=list(MESH_SHAPE), rtol=rtol,
                metrics={k: measured[k] for k in METRICS}))
            entry.update(status="updated")
        else:
            golden = load_golden(spec.name)
            if golden is None:
                entry.update(status="missing-golden",
                             why=f"no golden at {golden_path(spec.name)} -- "
                                 f"run --update-contracts")
                ok = False
            else:
                violations = diff_metrics(golden["metrics"], measured,
                                          rtol=golden.get("rtol", rtol))
                entry.update(status="fail" if violations else "ok",
                             golden=golden["metrics"],
                             violations=violations)
                ok = ok and not violations
        entries.append(entry)
    return ok, {"ok": ok, "rtol": rtol, "contracts": entries}
