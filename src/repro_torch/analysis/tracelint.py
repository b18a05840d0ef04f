"""Host-sync and launch-under-lock lint (asaplint pass 2 of the port).

The reference's pass 2 guards jitted JAX code against retraces.  The port
has no tracer: what breaks its serving loop is the host waiting on the card
where nobody counts it, and a first kernel call (which builds the library
with nvcc for tens of seconds) made while a lock stalls every other thread.
Each rule is the counterpart of a reference rule:

  sync-uncounted   (T2's counterpart) — a host sync in `core/`, `kernels/`
                   or `launch/` (or in any file that counts syncs) with no
                   `_launch.note_host_sync(...)` in the same block, so the
                   "host syncs per batch-layer" reading misses it.  A host
                   sync is `.item()` / `.tolist()` / `.cpu()` / `.numpy()`
                   on a tensor, `float()` / `int()` / `bool()` of a tensor,
                   `torch.cuda.synchronize()`, and `.synchronize()` on a CUDA
                   stream or event.  Only what the model ties to a tensor
                   (`model.tensor_names`) or to a stream or event is flagged.
  launch-under-lock (T4's counterpart) — a call of a kernel wrapper, of a
                   `lib.<name>_launch`, or of `_build.load()` inside
                   `with <lock>:`: the first call builds the library with
                   nvcc while the lock is held.
  sync-under-lock  (T4 too) — a host sync inside `with <lock>:`: the
                   holder sleeps on the card while others wait on it.

A lock is a class's declared lock (lockcheck's model) or a module-level
one (`_lock = threading.Lock()`).

Suppression: `# sync-ok: <reason>` on the flagged line (or the enclosing
statement's first line, or a standalone comment block above it).  An empty
reason is itself a finding (`sync-ok-no-reason`).
"""
from __future__ import annotations

import ast
import os
from typing import Dict, List, Optional, Sequence, Set

from repro_torch.analysis.model import (FileModel, ClassModel, _dotted,
                                        is_load_call, is_self_attr,
                                        is_tensor_expr, launch_calls,
                                        resolve_call, tensor_names_at,
                                        wrapper_names)
from repro_torch.analysis.report import Finding

_SYNC_METHODS = {"item", "tolist", "cpu", "numpy"}
_SYNC_BUILTINS = {"float", "int", "bool"}
#: `torch.cuda.<ctor>(...)` whose result `.synchronize()` waits on
_STREAM_CTORS = {"current_stream", "default_stream", "Stream", "Event",
                 "ExternalStream"}
#: directories whose host syncs must be counted
_COUNTED_DIRS = {"core", "kernels", "launch"}


def _is_note(node: ast.AST) -> bool:
    if not isinstance(node, ast.Call):
        return False
    f = node.func
    return (isinstance(f, ast.Attribute) and f.attr == "note_host_sync") \
        or (isinstance(f, ast.Name) and f.id == "note_host_sync")


def _is_stream_ctor(node: ast.AST) -> bool:
    if not isinstance(node, ast.Call):
        return False
    parts = _dotted(node.func)
    return bool(parts) and parts[:2] == ["torch", "cuda"] and \
        parts[-1] in _STREAM_CTORS


def _stream_attrs(cm: Optional[ClassModel]) -> Set[str]:
    """`self.X` the class binds to CUDA streams or events (directly or in
    a container built by a comprehension)."""
    out: Set[str] = set()
    if cm is None:
        return out
    for fn in cm.methods.values():
        for node in ast.walk(fn):
            if isinstance(node, ast.Assign) and any(
                    _is_stream_ctor(n) for n in ast.walk(node.value)):
                for tgt in node.targets:
                    attr = is_self_attr(tgt)
                    if attr:
                        out.add(attr)
    return out


class HostSyncPass:
    def __init__(self, models: Dict[str, FileModel]):
        self.models = {p: fm for p, fm in models.items() if fm.lang == "py"}
        self.findings: List[Finding] = []
        self.wrappers = wrapper_names(self.models)
        self._streams: Dict[int, Set[str]] = {}

    def run(self):
        for fm in self.models.values():
            counted = self._counted(fm)
            for fn, cm in self._functions(fm):
                self._check_function(fm, cm, fn, counted)
        return self.findings

    def _counted(self, fm: FileModel) -> bool:
        parts = set(os.path.normpath(fm.path).split(os.sep)[:-1])
        return bool(parts & _COUNTED_DIRS) or any(
            _is_note(n) for n in ast.walk(fm.tree))

    def _functions(self, fm: FileModel):
        """Every function of the file (nested ones apart from their
        parents), with the class that owns it, if any."""
        owner: Dict[int, ClassModel] = {}
        for cm in fm.classes.values():
            for fn in cm.methods.values():
                owner[id(fn)] = cm
        for node in ast.walk(fm.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                yield node, owner.get(id(node))

    def _finding(self, fm: FileModel, rule: str, line: int, msg: str,
                 stmt_line: Optional[int] = None):
        lines = [line, *([stmt_line] if stmt_line else [])]
        got = fm.suppression("sync-ok", *lines)
        reason, sline = got if got else (None, None)
        if reason == "":
            self.findings.append(Finding(
                rule="sync-ok-no-reason", path=fm.path, line=line,
                message="sync-ok suppression without a reason — record why "
                        "this sync or launch is safe here"))
            reason, sline = None, None
        self.findings.append(Finding(
            rule=rule, path=fm.path, line=line, message=msg,
            suppressed=reason is not None, reason=reason,
            suppress_line=sline))

    # ------------------------------------------------------------ syncs ---
    def _sync_of(self, node: ast.AST, fm: FileModel, names_at,
                 streams: Set[str], stream_attrs: Set[str]) -> Optional[str]:
        """What host sync `node` is, or None."""
        if not isinstance(node, ast.Call):
            return None
        names = names_at(node.lineno)
        f = node.func
        if isinstance(f, ast.Attribute):
            if f.attr in _SYNC_METHODS and \
                    is_tensor_expr(f.value, names, fm):
                return f".{f.attr}() on a tensor"
            if f.attr == "synchronize":
                parts = _dotted(f)
                if parts and parts[:2] == ["torch", "cuda"] and \
                        len(parts) == 3:
                    return "torch.cuda.synchronize()"
                recv = f.value
                while isinstance(recv, ast.Subscript):
                    recv = recv.value
                if _is_stream_ctor(recv) or \
                        (isinstance(recv, ast.Name) and recv.id in streams) \
                        or is_self_attr(recv) in stream_attrs:
                    return ".synchronize() on a CUDA stream or event"
        elif isinstance(f, ast.Name) and f.id in _SYNC_BUILTINS and \
                node.args and is_tensor_expr(node.args[0], names, fm):
            return f"{f.id}() of a tensor"
        return None

    def _check_function(self, fm: FileModel, cm: Optional[ClassModel],
                        fn: ast.FunctionDef, counted: bool):
        names = tensor_names_at(fn, fm)
        streams = {t.id for node in ast.walk(fn)
                   if isinstance(node, ast.Assign)
                   and _is_stream_ctor(node.value)
                   for t in node.targets if isinstance(t, ast.Name)}
        if id(cm) not in self._streams:
            self._streams[id(cm)] = _stream_attrs(cm)
        ctx = (fm, names, streams, self._streams[id(cm)])
        if counted:
            self._check_blocks(fn.body, ctx, fn.name)
        self._check_locked(fm, cm, fn.body, None, ctx)

    def _check_blocks(self, stmts: Sequence[ast.stmt], ctx, fname: str):
        """sync-uncounted: each host sync against the block it sits in."""
        fm = ctx[0]
        noted = any(_is_note(n) for s in stmts for n in _walk_no_defs(s))
        for stmt in stmts:
            for node in _own_nodes(stmt):
                what = self._sync_of(node, *ctx)
                if what and not noted:
                    self._finding(
                        fm, "sync-uncounted", node.lineno,
                        f"host sync ({what}) in {fname}() with no "
                        f"_launch.note_host_sync() in its block — the host "
                        f"syncs per batch-layer reading misses it",
                        stmt_line=stmt.lineno)
            for block in _blocks(stmt):
                self._check_blocks(block, ctx, fname)

    # ------------------------------------------------------------ locks ---
    def _lock_of(self, fm: FileModel, cm: Optional[ClassModel],
                 expr: ast.expr) -> Optional[str]:
        attr = is_self_attr(expr)
        if attr and cm is not None and attr in cm.locks:
            return f"self.{attr}"
        if isinstance(expr, ast.Name) and expr.id in fm.module_locks:
            return expr.id
        return None

    def _launch_of(self, node: ast.AST, fm: FileModel) -> Optional[str]:
        if not isinstance(node, ast.Call):
            return None
        if is_load_call(node, fm):
            return "_build.load()"
        target = resolve_call(node, fm, self.models)
        if target in self.wrappers:
            return f"kernel wrapper {target[1]}()"
        return None

    def _check_locked(self, fm: FileModel, cm: Optional[ClassModel],
                      stmts: Sequence[ast.stmt], lock: Optional[str], ctx):
        for stmt in stmts:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                continue  # runs later, in its own frame
            if isinstance(stmt, (ast.With, ast.AsyncWith)):
                here = lock
                for item in stmt.items:
                    here = self._lock_of(fm, cm, item.context_expr) or here
                self._check_locked(fm, cm, stmt.body, here, ctx)
                continue
            if lock is not None:
                owner = cm.name if cm is not None else "<module>"
                launched = {id(c) for _k, c in launch_calls(stmt, fm)}
                for node in _own_nodes(stmt):
                    what = self._launch_of(node, fm) or (
                        "a kernel launch" if id(node) in launched else None)
                    if what:
                        self._finding(
                            fm, "launch-under-lock", node.lineno,
                            f"{what} under `with {lock}:` in {owner} — a "
                            f"first call builds the kernels with nvcc while "
                            f"the lock is held", stmt_line=stmt.lineno)
                    what = self._sync_of(node, *ctx)
                    if what:
                        self._finding(
                            fm, "sync-under-lock", node.lineno,
                            f"host sync ({what}) under `with {lock}:` in "
                            f"{owner} — the holder waits on the card while "
                            f"other threads wait on it",
                            stmt_line=stmt.lineno)
            for block in _blocks(stmt):
                self._check_locked(fm, cm, block, lock, ctx)


def _blocks(stmt: ast.stmt) -> List[List[ast.stmt]]:
    """The statement lists nested directly in `stmt` (bodies, else and
    finally branches, handlers, match cases); none for a nested def."""
    if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                         ast.ClassDef)):
        return []
    out = []
    for field in ("body", "orelse", "finalbody"):
        block = getattr(stmt, field, None)
        if isinstance(block, list) and block and \
                isinstance(block[0], ast.stmt):
            out.append(block)
    for h in getattr(stmt, "handlers", []) or []:
        out.append(h.body)
    for case in getattr(stmt, "cases", []) or []:
        out.append(case.body)
    return out


def _own_nodes(stmt: ast.stmt):
    """The expression nodes of `stmt` itself: its nested statements and
    defs (and lambdas' later calls) excluded."""
    if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                         ast.ClassDef)):
        return
    stack = [c for c in ast.iter_child_nodes(stmt)
             if not isinstance(c, (ast.stmt, ast.excepthandler,
                                   ast.match_case))]
    while stack:
        node = stack.pop()
        if isinstance(node, ast.Lambda):
            continue
        yield node
        stack.extend(ast.iter_child_nodes(node))


def _walk_no_defs(stmt: ast.stmt):
    """ast.walk of `stmt` without descending into nested defs."""
    stack = [stmt]
    while stack:
        node = stack.pop()
        yield node
        for c in ast.iter_child_nodes(node):
            if not isinstance(c, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.ClassDef, ast.Lambda)):
                stack.append(c)


def check_host_syncs(models: Dict[str, FileModel]) -> List[Finding]:
    return HostSyncPass(models).run()
