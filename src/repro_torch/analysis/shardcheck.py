"""shardcheck — the dtype-policy half of the reference's shardcheck, in
torch idiom (asaplint pass 5 of the port).

The mesh-axis, PartitionSpec and logical-axis rules need a mesh; the port
has none until its SPMD half lands.  What applies to one card already is
the dtype policy: the kernels take fp32 and bf16, and a value silently
promoted to float64 leaves them (and runs at a fraction of the card's
rate), while a bf16 accumulator loses the sum's low bits.

  sc-f64-literal   `torch.float64` / `torch.double`, a `dtype="float64"`
                   (or "double") string, or `.double()` in the port's code
                   (host numpy float64 is not flagged)
  sc-bf16-accum    an accumulator created in bf16 (`torch.zeros/empty/full`
                   or their `_like` / `new_` forms with a bf16 dtype) and
                   then accumulated into (`+=`, `acc = acc + ...`,
                   `acc.add_(...)` and the other in-place adds) —
                   accumulate in fp32, cast once at the end

Suppression: `# shard-ok: <reason>` on the flagged line (or a standalone
comment block above it).  An empty reason is itself a finding
(`shard-ok-no-reason`).
"""
from __future__ import annotations

import ast
from typing import Dict, List, Optional

from repro_torch.analysis.model import FileModel
from repro_torch.analysis.report import Finding

_F64_NAMES = {"float64", "double"}
_ACC_CTORS = {"zeros", "empty", "full", "zeros_like", "empty_like",
              "full_like", "new_zeros", "new_empty", "new_full"}
_INPLACE_ADDS = {"add_", "addmm_", "addbmm_", "baddbmm_", "addcmul_",
                 "addmv_", "index_add_", "scatter_add_"}


def _call_name(node: ast.expr) -> Optional[str]:
    if not isinstance(node, ast.Call):
        return None
    f = node.func
    if isinstance(f, ast.Attribute):
        return f.attr
    if isinstance(f, ast.Name):
        return f.id
    return None


class DtypePolicyPass:
    def __init__(self, models: Dict[str, FileModel]):
        self.models = {p: fm for p, fm in models.items() if fm.lang == "py"}
        self.findings: List[Finding] = []

    def _finding(self, fm: FileModel, rule: str, line: int, msg: str):
        got = fm.suppression("shard-ok", line)
        reason, sline = got if got else (None, None)
        if reason == "":
            self.findings.append(Finding(
                rule="shard-ok-no-reason", path=fm.path, line=line,
                message="shard-ok suppression without a reason — record "
                        "why this dtype is safe here"))
            reason, sline = None, None
        self.findings.append(Finding(
            rule=rule, path=fm.path, line=line, message=msg,
            suppressed=reason is not None, reason=reason,
            suppress_line=sline))

    def run(self) -> List[Finding]:
        for fm in self.models.values():
            self._check_f64(fm)
            self._check_bf16_accum(fm)
        return self.findings

    # ------------------------------------------------------------ float64 --
    def _check_f64(self, fm: FileModel):
        for node in ast.walk(fm.tree):
            if isinstance(node, ast.Attribute) and node.attr in _F64_NAMES \
                    and isinstance(node.value, ast.Name) \
                    and node.value.id == "torch":
                self._finding(
                    fm, "sc-f64-literal", node.lineno,
                    f"torch.{node.attr} in the port's code — the kernels "
                    f"take fp32/bf16 and the card runs fp64 at a fraction "
                    f"of their rate; keep device code fp32/bf16")
            elif isinstance(node, ast.keyword) and node.arg == "dtype" and \
                    isinstance(node.value, ast.Constant) and \
                    node.value.value in _F64_NAMES:
                self._finding(
                    fm, "sc-f64-literal", node.value.lineno,
                    f"dtype={node.value.value!r} in the port's code — keep "
                    f"device code fp32/bf16")
            elif isinstance(node, ast.Call) and \
                    isinstance(node.func, ast.Attribute) and \
                    node.func.attr == "double" and not node.args:
                self._finding(
                    fm, "sc-f64-literal", node.lineno,
                    ".double() in the port's code — keep device code "
                    "fp32/bf16")

    # ------------------------------------------------------- bf16 accums --
    def _is_bf16_dtype(self, expr: Optional[ast.expr]) -> bool:
        if isinstance(expr, ast.Attribute) and expr.attr == "bfloat16":
            return True
        return isinstance(expr, ast.Constant) and expr.value == "bfloat16"

    def _check_bf16_accum(self, fm: FileModel):
        for fn in [n for n in ast.walk(fm.tree)
                   if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]:
            bf16_accs: Dict[str, int] = {}
            for node in ast.walk(fn):
                if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                        and isinstance(node.targets[0], ast.Name) \
                        and _call_name(node.value) in _ACC_CTORS:
                    dtype = next((k.value for k in node.value.keywords
                                  if k.arg == "dtype"), None)
                    if self._is_bf16_dtype(dtype):
                        bf16_accs[node.targets[0].id] = node.lineno
            if not bf16_accs:
                continue
            for node in ast.walk(fn):
                name = None
                if isinstance(node, ast.AugAssign) and \
                        isinstance(node.op, ast.Add) and \
                        isinstance(node.target, ast.Name):
                    name = node.target.id
                elif isinstance(node, ast.Assign) and \
                        len(node.targets) == 1 and \
                        isinstance(node.targets[0], ast.Name) and \
                        isinstance(node.value, ast.BinOp) and \
                        isinstance(node.value.op, ast.Add):
                    t = node.targets[0].id
                    if any(isinstance(s, ast.Name) and s.id == t
                           for s in ast.walk(node.value)):
                        name = t
                elif isinstance(node, ast.Call) and \
                        isinstance(node.func, ast.Attribute) and \
                        node.func.attr in _INPLACE_ADDS and \
                        isinstance(node.func.value, ast.Name):
                    name = node.func.value.id
                if name in bf16_accs:
                    self._finding(
                        fm, "sc-bf16-accum", bf16_accs.pop(name),
                        f"accumulator `{name}` is created in bf16 and "
                        f"accumulated into — bf16 has ~8 mantissa bits; "
                        f"accumulate in fp32 and cast once at the end")


def check_sharding(models: Dict[str, FileModel]) -> List[Finding]:
    return DtypePolicyPass(models).run()
