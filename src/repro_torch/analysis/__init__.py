"""asaplint for the port — project-native static analysis of the
PyTorch/CUDA package, plus its runtime lock sanitizer.

Five static passes over the threaded runtime, its kernel wrappers and the
CUDA sources (none needs nvcc or a card):

  lockcheck   — static lock discipline, the reference's pass as it is:
                `# guarded_by:` annotations enforced against `with <lock>:`
                scopes, predicate-free `Condition.wait`, `.acquire()`
                without a finally-release, lock-order cycles across
                methods, guarded private state reached from outside its
                class.  Suppression: `# race-ok: <reason>`.
  tracelint   — host syncs: a device-to-host read or stream wait that
                `_launch.note_host_sync()` does not count, and a kernel
                launch (whose first call builds the library with nvcc) or
                a host sync under a lock.  Suppression: `# sync-ok: <reason>`.
  kernelcheck — launch contracts: the `extern "C"` signatures of
                `csrc/*.cu` against the ctypes `argtypes` / `restype` of
                `kernels/_build.py::_declare`, and every
                `lib.<name>_launch` checked (`_launch.check`) and counted
                (`_launch.count_launch`).  Suppression: `# kernel-ok:
                <reason>` (`// kernel-ok:` in a `.cu`).
  shardcheck  — partition specs and the dtype policy: spec literals
                against the declared mesh axes, FSDP_ARCHS against the
                configs, `pshard.constrain` names against
                KNOWN_LOGICAL_AXES; float64 in the port's code, bf16
                accumulators.  Suppression: `# shard-ok: <reason>`.
  lockdep     — RUNTIME sanitizer: wraps `threading.Lock` / `RLock` /
                `Condition` for locks created inside this repo, learns the
                global lock order and reports inversions and blocking waits
                under an unrelated lock (`lockdep_active()`).

CLI: `python -m repro_torch.analysis [paths...] [--json out.json]
[--order] [--strict-suppressions]` — exits non-zero on any unsuppressed
static finding; `--strict-suppressions` also fails on suppression comments
that no longer match any finding, so annotations cannot rot.
`--contracts` / `--update-contracts` check the cost contracts instead
(`analysis.contracts`).
"""
from repro_torch.analysis.report import Finding, AnalysisResult
from repro_torch.analysis.model import build_models
from repro_torch.analysis.lockcheck import (LockDisciplinePass, check_locks,
                                            lock_order_edges)
from repro_torch.analysis.tracelint import check_host_syncs
from repro_torch.analysis.kernelcheck import check_kernels
from repro_torch.analysis.shardcheck import check_sharding

__all__ = ["Finding", "AnalysisResult", "build_models", "check_locks",
           "lock_order_edges", "check_host_syncs", "check_kernels",
           "check_sharding", "run_static"]


def _stale_suppressions(models, findings):
    """Suppression comments no findings consumed — dead annotations."""
    used = {(f.path, f.suppress_line) for f in findings
            if f.suppress_line is not None}
    out = []
    for fm in models.values():
        for line, kind, reason in fm.all_suppressions():
            if (fm.path, line) not in used:
                out.append(Finding(
                    rule="stale-suppression", path=fm.path, line=line,
                    message=f"`{fm.comment_prefix} {kind}: {reason}` no "
                            f"longer matches any finding — the hazard it "
                            f"justified is gone; delete the annotation"))
    return out


def run_static(paths, strict_suppressions: bool = False) -> "AnalysisResult":
    """Run all static passes over `paths` (files or directories; `.py`,
    `.cu` and `.cuh` files are read)."""
    from repro_torch.analysis.model import collect_files
    files = collect_files(paths)
    models = build_models(files)
    locks = LockDisciplinePass(models)  # one walk: findings and order graph
    locks.run()
    findings = locks.findings + check_host_syncs(models) \
        + check_kernels(models) + check_sharding(models)
    if strict_suppressions:
        findings += _stale_suppressions(models, findings)
    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return AnalysisResult(findings=findings, lock_edges=locks.edges,
                          files=[m.path for m in models.values()])
