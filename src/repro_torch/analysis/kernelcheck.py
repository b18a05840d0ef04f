"""kernelcheck — launch contracts of the port's CUDA kernels (asaplint
pass 4 of the port).

The kernels are loaded with ctypes: `kernels/_build.py::_declare` states
each `extern "C"` launch function's `argtypes` and `restype` by hand, and
nothing checks them against the C signatures in `csrc/*.cu`.  On the card
a wrong count or type is not an error but silent memory corruption.  The
wrappers in turn must hand every launch's return code to `_launch.check`
(a failed launch raises) and count it with `_launch.count_launch` (the
launch counts by route are the port's probes).  Read with no nvcc and no
card — the C side is parsed, the `argtypes` expressions are evaluated on
the AST:

  kc-abi-arity        `argtypes` has another length than the C parameter
                      list (or is missing)
  kc-abi-type         a position whose ctypes type is not the C type's
                      (`T*` -> c_void_p, `int` -> c_int, `long long` ->
                      c_longlong, `float` -> c_float; another C type has
                      no mapping), or a `restype` that is not c_int for
                      the C `int` every launch function returns
  kc-abi-undeclared   an `extern "C"` function with no `_declare` entry
  kc-abi-unknown      a `_declare` entry with no `extern "C"` function
  kc-unchecked-launch a `lib.<name>_launch(...)` whose return code does
                      not reach `_launch.check`
  kc-uncounted-launch a function that calls `lib.<name>_launch` but never
                      `_launch.count_launch`

The ABI rules run when the analyzed files hold both sides: a `_declare`
function and CUDA sources with `extern "C"` functions.

Suppression: `# kernel-ok: <reason>` on the flagged line (`// kernel-ok:`
in a `.cu`), or a standalone comment block above it.  An empty reason is
itself a finding (`kernel-ok-no-reason`).
"""
from __future__ import annotations

import ast
import dataclasses
import re
from typing import Dict, List, Optional, Tuple

from repro_torch.analysis.model import FileModel, launch_calls, scan_cu
from repro_torch.analysis.report import Finding

#: C parameter type -> the ctypes type `argtypes` must name
C_TO_CTYPES = {"void*": "c_void_p", "int": "c_int",
               "long long": "c_longlong", "float": "c_float"}

_EXTERN_RE = re.compile(
    r'extern\s+"C"\s+(?!\{)([A-Za-z_][\w\s\*&]*?)\s*\b([A-Za-z_]\w*)\s*'
    r'\(([^)]*)\)')
_QUALIFIERS = {"const", "volatile", "__restrict__", "restrict",
               "__restrict", "struct"}
_TYPE_WORDS = {"void", "int", "long", "float", "double", "char", "short",
               "unsigned", "signed", "bool", "size_t"}


@dataclasses.dataclass
class CSignature:
    name: str
    ret: str
    params: List[str]  # normalized C types ("void*", "int", ...)
    path: str
    line: int


@dataclasses.dataclass
class Declared:
    name: str
    path: str
    line: int  # the `argtypes` line (the `restype` line without one)
    argtypes: Optional[List[str]] = None  # ctypes names, or None
    restype: Optional[str] = None
    restype_line: Optional[int] = None
    unresolved: Optional[str] = None  # why argtypes did not evaluate


def c_type(param: str) -> str:
    """A C parameter's type, normalized: any pointer -> "void*", else the
    type words with the parameter's name and qualifiers dropped."""
    param = param.split("=")[0].strip()
    if "*" in param or "&" in param:
        return "void*"
    words = [w for w in param.split() if w not in _QUALIFIERS]
    if len(words) > 1 and words[-1] not in _TYPE_WORDS:
        words = words[:-1]  # the parameter's name
    return " ".join(words)


def parse_externs(fm: FileModel) -> List[CSignature]:
    """Every `extern "C" <ret> <name>(<params>)` of a CUDA source."""
    _comments, code = scan_cu(fm.source)
    out = []
    for m in _EXTERN_RE.finditer(code):
        ret, name, params = m.group(1), m.group(2), m.group(3).strip()
        plist = [] if params in ("", "void") else \
            [c_type(p) for p in params.split(",")]
        out.append(CSignature(
            name=name, ret=" ".join(ret.split()), params=plist,
            path=fm.path, line=code.count("\n", 0, m.start()) + 1))
    return out


# ---------------------------------------------------------------------------
# evaluating `argtypes` on the AST
# ---------------------------------------------------------------------------


class _Unresolved(Exception):
    pass


def _module_env(fm: FileModel) -> Dict[str, ast.expr]:
    """Module-level `NAME = expr` bindings, tuple assignments unpacked."""
    env: Dict[str, ast.expr] = {}
    for node in fm.tree.body:
        if not isinstance(node, ast.Assign):
            continue
        for tgt in node.targets:
            if isinstance(tgt, ast.Name):
                env[tgt.id] = node.value
            elif isinstance(tgt, ast.Tuple) and \
                    isinstance(node.value, ast.Tuple) and \
                    len(tgt.elts) == len(node.value.elts):
                for t, v in zip(tgt.elts, node.value.elts):
                    if isinstance(t, ast.Name):
                        env[t.id] = v
    return env


def _eval(node: ast.expr, env: Dict[str, ast.expr], depth: int = 0):
    """A ctypes name ("c_int"), a list of them, or an int."""
    if depth > 16:
        raise _Unresolved("binding chain too deep")
    if isinstance(node, ast.Constant) and isinstance(node.value, int):
        return node.value
    if isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name) \
            and node.value.id == "ctypes":
        return node.attr
    if isinstance(node, ast.Name):
        if node.id not in env:
            raise _Unresolved(f"`{node.id}` is not bound at module level")
        return _eval(env[node.id], env, depth + 1)
    if isinstance(node, (ast.List, ast.Tuple)):
        return [_eval(e, env, depth + 1) for e in node.elts]
    if isinstance(node, ast.BinOp):
        a, b = _eval(node.left, env, depth + 1), \
            _eval(node.right, env, depth + 1)
        if isinstance(node.op, ast.Add) and isinstance(a, list) \
                and isinstance(b, list):
            return a + b
        if isinstance(node.op, ast.Mult):
            if isinstance(a, list) and isinstance(b, int):
                return a * b
            if isinstance(a, int) and isinstance(b, list):
                return b * a
    raise _Unresolved(f"cannot evaluate `{ast.unparse(node)}`")


def parse_declare(fm: FileModel) -> List[Declared]:
    """The entries of every `_declare(lib)` function of a file:
    `lib.<name>.argtypes = ...` and `lib.<name>.restype = ...`."""
    env = _module_env(fm)
    out: Dict[str, Declared] = {}
    for fn in fm.tree.body:
        if not (isinstance(fn, ast.FunctionDef) and fn.name == "_declare"):
            continue
        for node in ast.walk(fn):
            if not (isinstance(node, ast.Assign) and len(node.targets) == 1):
                continue
            tgt = node.targets[0]
            if not (isinstance(tgt, ast.Attribute)
                    and tgt.attr in ("argtypes", "restype")
                    and isinstance(tgt.value, ast.Attribute)):
                continue
            name = tgt.value.attr
            d = out.setdefault(name, Declared(name=name, path=fm.path,
                                              line=node.lineno))
            try:
                val = _eval(node.value, env)
            except _Unresolved as ex:
                val, why = None, str(ex)
            else:
                why = None
            if tgt.attr == "argtypes":
                d.line = node.lineno
                if isinstance(val, list) and all(isinstance(v, str)
                                                 for v in val):
                    d.argtypes = val
                else:
                    d.unresolved = why or "not a list of ctypes types"
            else:
                d.restype = val if isinstance(val, str) else None
                d.restype_line = node.lineno
    return list(out.values())


# ---------------------------------------------------------------------------
# the pass
# ---------------------------------------------------------------------------


class KernelContractPass:
    def __init__(self, models: Dict[str, FileModel]):
        self.models = models
        self.findings: List[Finding] = []

    def _finding(self, fm: FileModel, rule: str, line: int, msg: str):
        got = fm.suppression("kernel-ok", line)
        reason, sline = got if got else (None, None)
        if reason == "":
            self.findings.append(Finding(
                rule="kernel-ok-no-reason", path=fm.path, line=line,
                message="kernel-ok suppression without a reason — record "
                        "why this launch contract is safe to break"))
            reason, sline = None, None
        self.findings.append(Finding(
            rule=rule, path=fm.path, line=line, message=msg,
            suppressed=reason is not None, reason=reason,
            suppress_line=sline))

    def run(self) -> List[Finding]:
        externs: List[CSignature] = []
        declared: List[Declared] = []
        for fm in self.models.values():
            if fm.lang == "cu":
                externs += parse_externs(fm)
            else:
                declared += parse_declare(fm)
                self._check_launches(fm)
        if externs and declared:
            self._check_abi(externs, declared)
        return self.findings

    # ---------------------------------------------------------------- ABI --
    def _check_abi(self, externs: List[CSignature],
                   declared: List[Declared]):
        by_c: Dict[str, CSignature] = {s.name: s for s in externs}
        by_py: Dict[str, Declared] = {d.name: d for d in declared}
        for sig in externs:
            if sig.name not in by_py:
                self._finding(
                    self.models[sig.path], "kc-abi-undeclared", sig.line,
                    f'extern "C" {sig.name} has no _declare entry: ctypes '
                    f"would pass every argument as a C int")
        for d in declared:
            fm = self.models[d.path]
            sig = by_c.get(d.name)
            if sig is None:
                self._finding(fm, "kc-abi-unknown", d.line,
                              f'_declare entry {d.name} names no extern "C" '
                              f"function of the CUDA sources")
                continue
            self._check_entry(fm, d, sig)

    def _check_entry(self, fm: FileModel, d: Declared, sig: CSignature):
        where = f"{sig.path}:{sig.line}"
        if d.argtypes is None:
            why = d.unresolved or "no argtypes"
            self._finding(fm, "kc-abi-arity", d.line,
                          f"{d.name}: argtypes cannot be read ({why}); the "
                          f"C function at {where} takes {len(sig.params)}")
        elif len(d.argtypes) != len(sig.params):
            self._finding(
                fm, "kc-abi-arity", d.line,
                f"{d.name}: argtypes has {len(d.argtypes)} entries, the C "
                f"function at {where} takes {len(sig.params)} parameters")
        else:
            bad: List[Tuple[int, str, str]] = []
            for i, (py, c) in enumerate(zip(d.argtypes, sig.params)):
                want = C_TO_CTYPES.get(c)
                if want != py:
                    bad.append((i, c, py))
            if bad:
                self._finding(
                    fm, "kc-abi-type", d.line,
                    f"{d.name}: " + "; ".join(
                        f"parameter {i} is C `{c}` "
                        + (f"(ctypes {C_TO_CTYPES[c]})" if c in C_TO_CTYPES
                           else "(no ctypes mapping)")
                        + f" but argtypes says {py}" for i, c, py in bad)
                    + f" ({where})")
        if sig.ret != "int":
            self._finding(fm, "kc-abi-type", d.line,
                          f"{d.name}: the C function returns `{sig.ret}`; "
                          f"a launch function returns an int error code "
                          f"({where})")
        elif d.restype != "c_int":
            self._finding(fm, "kc-abi-type", d.restype_line or d.line,
                          f"{d.name}: restype is {d.restype or 'unset'}; "
                          f"the C function returns int ({where})")

    # ----------------------------------------------------------- launches --
    def _check_launches(self, fm: FileModel):
        for fn in ast.walk(fm.tree):
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            calls = [(k, c) for k, c in launch_calls(fn, fm)
                     if _innermost_def(fn, c)]
            if not calls:
                continue
            checked = _checked_values(fn)
            counted = any(isinstance(n, ast.Call) and _call_attr(n)
                          == "count_launch" for n in ast.walk(fn))
            for kernel, call in calls:
                if id(call) not in checked:
                    self._finding(
                        fm, "kc-unchecked-launch", call.lineno,
                        f"{kernel}_launch's return code in {fn.name}() "
                        f"does not reach _launch.check: a failed launch "
                        f"goes unnoticed")
                if not counted:
                    self._finding(
                        fm, "kc-uncounted-launch", call.lineno,
                        f"{fn.name}() launches {kernel} but never calls "
                        f"_launch.count_launch: the launch counts by route "
                        f"miss it")


def _call_attr(node: ast.Call) -> Optional[str]:
    f = node.func
    if isinstance(f, ast.Attribute):
        return f.attr
    if isinstance(f, ast.Name):
        return f.id
    return None


def _innermost_def(fn: ast.AST, target: ast.AST) -> bool:
    """True when `fn` is the innermost def holding `target`."""
    for node in ast.walk(fn):
        if node is not fn and isinstance(
                node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            if any(n is target for n in ast.walk(node)):
                return False
    return True


def _checked_values(fn: ast.AST) -> set:
    """ids of the calls whose value reaches a `check(...)` call of `fn`:
    passed to it directly, or through a name assigned the call."""
    checked_names, out = set(), set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Call) and _call_attr(node) == "check":
            for a in node.args:
                if isinstance(a, ast.Name):
                    checked_names.add(a.id)
                elif isinstance(a, ast.Call):
                    out.add(id(a))
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Call) \
                and any(isinstance(t, ast.Name) and t.id in checked_names
                        for t in node.targets):
            out.add(id(node.value))
    return out


def check_kernels(models: Dict[str, FileModel]) -> List[Finding]:
    return KernelContractPass(models).run()
