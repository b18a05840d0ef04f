"""shardcheck -- partition-spec / mesh-axis / dtype-policy contracts of
the port (asaplint pass 5), the reference's shardcheck in torch idiom.

A spec naming a mesh axis no mesh has, an FSDP_ARCHS entry that matches no
config, or a logical-axis hint no rule can map is a silent no-op: the
tensor simply stays replicated and the cost shows up three layers away.
The mesh rules harvest the declared universes from the analyzed files
themselves and cross-check every use:

  sc-unknown-mesh-axis    a string in a `P(...)` / `PartitionSpec(...)`
                          literal (the port's `launch.sharding` spec) that
                          no mesh declares (harvested from the axis names of
                          `init_device_mesh` / `DeviceMesh` / `_device_mesh`
                          / `AbstractMesh` calls)
  sc-duplicate-mesh-axis  the same mesh axis named twice in one spec
  sc-spec-rank            a spec longer than the ndim of the tensor it is
                          passed with, where that tensor's shape is a
                          literal (`torch.zeros((4, 8))`, `torch.ones(4)`)
  sc-fsdp-unknown-arch    an FSDP_ARCHS entry naming no known config
                          (harvested from ARCHS / EXTRA_ARCHS / _ALIASES)
  sc-unknown-logical-axis a `pshard.constrain(...)` name outside
                          KNOWN_LOGICAL_AXES -- no rule would ever map it

The dtype policy: the kernels take fp32 and bf16, and a value silently
promoted to float64 leaves them (and runs at a fraction of the card's
rate), while a bf16 accumulator loses the sum's low bits.

  sc-f64-literal   `torch.float64` / `torch.double`, a `dtype="float64"`
                   (or "double") string, or `.double()` in the port's code
                   (host numpy float64 is not flagged)
  sc-bf16-accum    an accumulator created in bf16 (`torch.zeros/empty/full`
                   or their `_like` / `new_` forms with a bf16 dtype) and
                   then accumulated into (`+=`, `acc = acc + ...`,
                   `acc.add_(...)` and the other in-place adds) --
                   accumulate in fp32, cast once at the end

Suppression: `# shard-ok: <reason>` on the flagged line (or a standalone
comment block above it).  An empty reason is itself a finding
(`shard-ok-no-reason`).
"""
from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from repro_torch.analysis.model import FileModel
from repro_torch.analysis.report import Finding

_F64_NAMES = {"float64", "double"}
_ACC_CTORS = {"zeros", "empty", "full", "zeros_like", "empty_like",
              "full_like", "new_zeros", "new_empty", "new_full"}
_INPLACE_ADDS = {"add_", "addmm_", "addbmm_", "baddbmm_", "addcmul_",
                 "addmv_", "index_add_", "scatter_add_"}


_MESH_CTORS = {"init_device_mesh": 2, "DeviceMesh": 2, "_device_mesh": 2,
               "AbstractMesh": 0}  # -> positional index of the axis names
_MESH_KW = {"mesh_dim_names", "axis_names", "names"}
_SPEC_NAMES = {"P", "PartitionSpec"}
_SHAPE_CTORS = {"zeros", "ones", "empty", "randn", "rand", "full"}
_ARCH_LIST_NAMES = {"ARCHS", "EXTRA_ARCHS", "_ALIASES"}


def _call_name(node: ast.expr) -> Optional[str]:
    if not isinstance(node, ast.Call):
        return None
    f = node.func
    if isinstance(f, ast.Attribute):
        return f.attr
    if isinstance(f, ast.Name):
        return f.id
    return None


def _strings_in(expr: Optional[ast.expr]) -> List[str]:
    if expr is None:
        return []
    return [n.value for n in ast.walk(expr)
            if isinstance(n, ast.Constant) and isinstance(n.value, str)]


def _assigns(scope: ast.AST) -> Dict[str, ast.expr]:
    """name -> value of every single-target assignment under `scope`."""
    out: Dict[str, ast.expr] = {}
    for node in ast.walk(scope):
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name):
            out[node.targets[0].id] = node.value
    return out


def _module_sets(models: Dict[str, FileModel], names: Set[str]) \
        -> List[Tuple[FileModel, int, str, Set[str]]]:
    """(file, line, name, strings) of each module-level `name = <literal>`
    (a set, list, dict or `frozenset({...})`)."""
    out = []
    for fm in models.values():
        for node in fm.tree.body:
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name) \
                    and node.targets[0].id in names:
                out.append((fm, node.lineno, node.targets[0].id,
                            set(_strings_in(node.value))))
    return out


def harvest_mesh_axes(models: Dict[str, FileModel]) -> Set[str]:
    """Axis names of the mesh constructors' calls, a name argument resolved
    through the assignments of its file (a conditional tuple gives every
    branch's names)."""
    axes: Set[str] = set()
    for fm in models.values():
        for scope, env in _scopes(fm):
            axes.update(_ctor_axes(scope, env))
    return axes


def _scopes(fm: FileModel):
    """(scope, env) of the module and of each function: the module's
    top-level assignments, and a function's own over them."""
    top = {n.targets[0].id: n.value for n in fm.tree.body
           if isinstance(n, ast.Assign) and len(n.targets) == 1
           and isinstance(n.targets[0], ast.Name)}
    yield fm.tree, top
    for fn in ast.walk(fm.tree):
        if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield fn, {**top, **_assigns(fn)}


def _ctor_axes(scope: ast.AST, env: Dict[str, ast.expr]) -> Set[str]:
    axes: Set[str] = set()
    for node in ast.walk(scope):
        name = _call_name(node)
        if name not in _MESH_CTORS:
            continue
        arg = next((k.value for k in node.keywords
                    if k.arg in _MESH_KW), None)
        i = _MESH_CTORS[name]
        if arg is None and len(node.args) > i:
            arg = node.args[i]
        if isinstance(arg, ast.Name):
            arg = env.get(arg.id)
        axes.update(_strings_in(arg))
    return axes


def _is_spec_call(node: ast.AST) -> bool:
    if not isinstance(node, ast.Call):
        return False
    f = node.func
    if isinstance(f, ast.Attribute):
        return f.attr in _SPEC_NAMES
    return isinstance(f, ast.Name) and f.id in _SPEC_NAMES


def _literal_rank(expr: ast.expr, env: Dict[str, ast.expr]) -> Optional[int]:
    """ndim of `torch.zeros((4, 8))` / `torch.ones(4, 8)` (through one
    local name), else None."""
    if isinstance(expr, ast.Name) and expr.id in env:
        expr = env[expr.id]
    if not (isinstance(expr, ast.Call) and _call_name(expr) in _SHAPE_CTORS
            and expr.args):
        return None
    first = expr.args[0]
    if isinstance(first, (ast.Tuple, ast.List)):
        if any(isinstance(e, ast.Starred) for e in first.elts):
            return None
        return len(first.elts)
    if _call_name(expr) == "full" or \
            any(isinstance(a, ast.Starred) for a in expr.args):
        return None
    return len(expr.args)


class MeshRulesPass:
    def __init__(self, models: Dict[str, FileModel], finding):
        self.models = models
        self._finding = finding
        self.mesh_axes = harvest_mesh_axes(models)
        self.arch_names: Set[str] = set()
        for _fm, _ln, _n, strs in _module_sets(models, _ARCH_LIST_NAMES):
            self.arch_names |= strs
        self.logical_axes: Set[str] = set()
        for _fm, _ln, _n, strs in _module_sets(models,
                                               {"KNOWN_LOGICAL_AXES"}):
            self.logical_axes |= strs

    def run(self):
        if self.arch_names:
            for fm, line, _n, entries in _module_sets(self.models,
                                                      {"FSDP_ARCHS"}):
                for e in sorted(entries - self.arch_names):
                    self._finding(
                        fm, "sc-fsdp-unknown-arch", line,
                        f"FSDP_ARCHS entry '{e}' matches no known config "
                        f"(ARCHS/EXTRA_ARCHS/_ALIASES) -- the ZeRO-3 rule "
                        f"is dead for it")
        for fm in self.models.values():
            self._check_specs(fm)
            self._check_ranks(fm)
            self._check_constrain(fm)

    def _check_specs(self, fm: FileModel):
        for node in ast.walk(fm.tree):
            if not _is_spec_call(node):
                continue
            entries = []
            for a in node.args:
                elts = a.elts if isinstance(a, (ast.Tuple, ast.List)) else [a]
                entries += [(e.value, e.lineno) for e in elts
                            if isinstance(e, ast.Constant)
                            and isinstance(e.value, str)]
            seen: Set[str] = set()
            for ax, ln in entries:
                if self.mesh_axes and ax not in self.mesh_axes:
                    self._finding(
                        fm, "sc-unknown-mesh-axis", ln,
                        f"partition spec names mesh axis '{ax}' but the "
                        f"declared meshes only have "
                        f"{sorted(self.mesh_axes)} -- this spec can never "
                        f"apply")
                if ax in seen:
                    self._finding(
                        fm, "sc-duplicate-mesh-axis", ln,
                        f"mesh axis '{ax}' appears twice in one partition "
                        f"spec -- an axis can shard only one dim")
                seen.add(ax)

    def _check_ranks(self, fm: FileModel):
        seen: Set[int] = set()  # a call inside a function is in two scopes
        for fn, env in _scopes(fm):
            for node in ast.walk(fn):
                if not isinstance(node, ast.Call) or not node.args:
                    continue
                rank = _literal_rank(node.args[0], env)
                if rank is None:
                    continue
                for a in node.args[1:]:
                    for spec in ast.walk(a):
                        if _is_spec_call(spec) and not any(
                                isinstance(x, ast.Starred)
                                for x in spec.args) \
                                and len(spec.args) > rank \
                                and spec.lineno not in seen:
                            seen.add(spec.lineno)
                            self._finding(
                                fm, "sc-spec-rank", spec.lineno,
                                f"partition spec has {len(spec.args)} "
                                f"entries for a rank-{rank} tensor -- a "
                                f"spec longer than ndim places nothing")

    def _check_constrain(self, fm: FileModel):
        if not self.logical_axes:
            return
        for node in ast.walk(fm.tree):
            if not (isinstance(node, ast.Call)
                    and _call_name(node) == "constrain"):
                continue
            for a in node.args[1:]:
                if isinstance(a, ast.Constant) and isinstance(a.value, str) \
                        and a.value not in self.logical_axes:
                    self._finding(
                        fm, "sc-unknown-logical-axis", a.lineno,
                        f"constrain() names logical axis '{a.value}' which "
                        f"is not in pshard.KNOWN_LOGICAL_AXES -- no rule "
                        f"will ever map it (silent no-op)")


class ShardCheck:
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
                        "why this sharding or dtype contract is safe to "
                        "break"))
            reason, sline = None, None
        self.findings.append(Finding(
            rule=rule, path=fm.path, line=line, message=msg,
            suppressed=reason is not None, reason=reason,
            suppress_line=sline))

    def run(self) -> List[Finding]:
        MeshRulesPass(self.models, self._finding).run()
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
    return ShardCheck(models).run()
