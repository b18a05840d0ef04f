"""Static lock-discipline pass (asaplint pass 1 of the port).

The reference's pass, ported as it is: the rules, the grammar and the
lock-order graph are the same, and so are its findings on the same files.

Rules (rule ids are stable — tests and triage reference them):

  unguarded-access   (R1) — a `# guarded_by: L` attribute is read or written
                     outside a `with self.L:` scope in its owning class.
                     `guarded_by: protocol` can never be discharged by a
                     `with` — every access needs a `# race-ok: <reason>`.
  foreign-access     (R2) — a guarded *private* attribute (leading `_`) is
                     reached through a non-self receiver from a class that
                     does not own it (the `buf._bits` class of bug: the
                     analysis cannot prove the owner's lock is held).
  naked-wait         (R3) — `Condition.wait()` outside a `while` predicate
                     loop (lost-wakeup bug class; `wait_for` is exempt), or
                     a wait on a condition whose lock is not held.
  acquire-no-release (R4) — `.acquire()` on a declared lock in a method with
                     no `.release()` of that lock in any `finally:` block.
  lock-order-cycle   (R5) — the static lock-ordering graph (edges: lock A
                     held while acquiring lock B, following one level of
                     cross-object calls) contains a cycle.

Suppression: `# race-ok: <reason>` on the flagged line (or the enclosing
statement's first line).  An empty reason is itself a finding
(`race-ok-no-reason`) — the point is recording intent in-tree.

Known static-model limitation: two `with` receivers naming the SAME runtime
lock through different classes (e.g. `MoEDeviceBuffer._cv` handed to its
`Bitmap`s) appear as distinct graph nodes here; the runtime lockdep
sanitizer (analysis/lockdep.py) keys on lock *objects* and covers that gap.
"""
from __future__ import annotations

import ast
import dataclasses
from typing import Dict, List, Optional, Sequence, Set, Tuple

from repro_torch.analysis.model import (ClassModel, FileModel, PROTOCOL_GUARD,
                                  class_registry, is_self_attr)
from repro_torch.analysis.report import Finding

_MAX_CALL_DEPTH = 8


@dataclasses.dataclass
class _Ctx:
    """One method-walk context (shared mutable state lives on the pass)."""
    fm: FileModel
    cm: Optional[ClassModel]
    self_name: str = "self"
    checking: bool = True  # emit R1-R4 findings (False when followed into)
    held: Tuple[str, ...] = ()  # canonical lock keys, acquisition order
    while_depth: int = 0
    stmt_line: Optional[int] = None  # enclosing statement's first line
    env: Dict[str, Tuple[str, str]] = dataclasses.field(default_factory=dict)
    # env: local name -> ("class", ClassName) | ("method", ClassName)


class LockDisciplinePass:
    def __init__(self, models: Dict[str, FileModel]):
        self.models = models
        self.registry = class_registry(models)
        self.findings: List[Finding] = []
        # (holder_key, acquired_key) -> witness descriptions
        self.edges: Dict[Tuple[str, str], List[str]] = {}
        # guarded private attr name -> owning class name (for R2)
        self.guarded_private: Dict[str, str] = {}
        for cm in self.registry.values():
            for attr in cm.guards:
                if attr.startswith("_"):
                    self.guarded_private.setdefault(attr, cm.name)
        self._chain: List[Tuple[str, str]] = []  # (class, method) call chain

    # ----------------------------------------------------------- utilities --
    def _finding(self, ctx: _Ctx, rule: str, node: ast.AST, msg: str):
        if not ctx.checking:
            return
        line = node.lineno
        lines = [line, *([ctx.stmt_line] if ctx.stmt_line else [])]
        got = ctx.fm.suppression("race-ok", *lines)
        reason, sline = got if got else (None, None)
        if reason == "":
            self.findings.append(Finding(
                rule="race-ok-no-reason", path=ctx.fm.path, line=line,
                message="race-ok suppression without a reason — record why "
                        "this access is protocol-safe"))
            reason, sline = None, None
        self.findings.append(Finding(
            rule=rule, path=ctx.fm.path, line=line, message=msg,
            suppressed=reason is not None, reason=reason,
            suppress_line=sline))

    def _lock_key(self, cm: ClassModel, attr: str) -> str:
        return f"{cm.name}.{cm.canonical_lock(attr)}"

    def _add_edges(self, ctx: _Ctx, key: str, node: ast.AST):
        where = f"{ctx.fm.path}:{node.lineno}"
        if self._chain:
            where += " via " + ".".join(f"{c}.{m}" for c, m in self._chain[:1])
        for h in ctx.held:
            if h != key:
                self.edges.setdefault((h, key), [])
                if where not in self.edges[(h, key)]:
                    self.edges[(h, key)].append(where)

    def _resolve_class(self, ctx: _Ctx, expr: ast.expr) -> Optional[str]:
        """Class of the object `expr` evaluates to (None if unknown)."""
        if isinstance(expr, ast.Name):
            if expr.id == ctx.self_name and ctx.cm is not None:
                return ctx.cm.name
            b = ctx.env.get(expr.id)
            if b and b[0] == "class":
                return b[1]
            return None
        if isinstance(expr, ast.Subscript):
            return self._resolve_class(ctx, expr.value)
        if isinstance(expr, ast.Attribute):
            base = self._resolve_class(ctx, expr.value)
            if base and base in self.registry:
                bound = self.registry[base].attr_classes.get(expr.attr)
                return bound
            return None
        return None

    # -------------------------------------------------------- pass drivers --
    def run(self):
        for fm in self.models.values():
            for cm in fm.classes.values():
                for mname, fn in cm.methods.items():
                    self._check_method_acquires(fm, cm, fn)
                    ctx = _Ctx(fm=fm, cm=cm,
                               self_name=self._self_name(fn))
                    if mname == "__init__":
                        # construction happens-before publication: guarded
                        # state may be initialized lock-free, but lock ORDER
                        # edges (e.g. a ctor taking locks) still count
                        ctx = dataclasses.replace(ctx, checking=False)
                    self._walk_body(fn.body, ctx)
            # module-level functions: R2/R3 surface there too
            for node in fm.tree.body:
                if isinstance(node, ast.FunctionDef):
                    ctx = _Ctx(fm=fm, cm=None, self_name="\0none")
                    self._walk_body(node.body, ctx)
        self._detect_cycles()

    def _self_name(self, fn: ast.FunctionDef) -> str:
        if fn.args.args:
            return fn.args.args[0].arg
        return "self"

    # --------------------------------------------------- R4: acquire scan --
    def _check_method_acquires(self, fm: FileModel, cm: ClassModel,
                               fn: ast.FunctionDef):
        self_name = self._self_name(fn)
        released_in_finally: Set[str] = set()
        for node in ast.walk(fn):
            if isinstance(node, ast.Try):
                for stmt in node.finalbody:
                    for sub in ast.walk(stmt):
                        if isinstance(sub, ast.Call) and \
                                isinstance(sub.func, ast.Attribute) and \
                                sub.func.attr == "release":
                            attr = is_self_attr(sub.func.value, self_name)
                            if attr:
                                released_in_finally.add(attr)
        for node in ast.walk(fn):
            if isinstance(node, ast.Call) and \
                    isinstance(node.func, ast.Attribute) and \
                    node.func.attr == "acquire":
                attr = is_self_attr(node.func.value, self_name)
                if attr and attr in cm.locks and \
                        attr not in released_in_finally:
                    got = fm.suppression("race-ok", node.lineno)
                    reason, sline = got if got else (None, None)
                    self.findings.append(Finding(
                        rule="acquire-no-release", path=fm.path,
                        line=node.lineno,
                        message=f"{cm.name}.{attr}.acquire() without a "
                                f"matching release() in a finally: block — "
                                f"an exception leaks the lock",
                        suppressed=reason is not None, reason=reason,
                        suppress_line=sline))

    # ------------------------------------------------------- the walker ----
    def _walk_body(self, stmts: Sequence[ast.stmt], ctx: _Ctx):
        held = ctx.held
        for stmt in stmts:
            ctx = dataclasses.replace(ctx, held=held)
            self._walk_stmt(stmt, ctx)
            # linear acquire()/release() tracking (the with-less pattern:
            # `if not self.L.acquire(...): return` ... try/finally release)
            held = self._apply_acquires(stmt, ctx, held)

    def _apply_acquires(self, stmt: ast.stmt, ctx: _Ctx,
                        held: Tuple[str, ...]) -> Tuple[str, ...]:
        if ctx.cm is None:
            return held
        for node in ast.walk(stmt):
            if isinstance(node, ast.Call) and \
                    isinstance(node.func, ast.Attribute):
                attr = is_self_attr(node.func.value, ctx.self_name)
                if attr and attr in ctx.cm.locks:
                    key = self._lock_key(ctx.cm, attr)
                    if node.func.attr == "acquire" and key not in held:
                        self._add_edges(
                            dataclasses.replace(ctx, held=held), key, node)
                        held = held + (key,)
                    elif node.func.attr == "release" and key in held:
                        held = tuple(k for k in held if k != key)
        return held

    def _walk_stmt(self, stmt: ast.stmt, ctx: _Ctx):
        ctx = dataclasses.replace(ctx, stmt_line=stmt.lineno)
        if isinstance(stmt, (ast.With, ast.AsyncWith)):
            acquired: List[str] = []
            for item in stmt.items:
                self._walk_expr(item.context_expr, ctx, store=False)
                attr = is_self_attr(item.context_expr, ctx.self_name)
                if attr and ctx.cm is not None and attr in ctx.cm.locks:
                    key = self._lock_key(ctx.cm, attr)
                    self._add_edges(ctx, key, item.context_expr)
                    acquired.append(key)
            inner = dataclasses.replace(
                ctx, held=ctx.held + tuple(k for k in acquired
                                           if k not in ctx.held))
            self._walk_body(stmt.body, inner)
        elif isinstance(stmt, ast.While):
            self._walk_expr(stmt.test, ctx, store=False)
            inner = dataclasses.replace(ctx,
                                        while_depth=ctx.while_depth + 1)
            self._walk_body(stmt.body, inner)
            self._walk_body(stmt.orelse, ctx)
        elif isinstance(stmt, (ast.For, ast.AsyncFor)):
            self._walk_expr(stmt.iter, ctx, store=False)
            env = dict(ctx.env)
            bound = self._resolve_class(ctx, stmt.iter)
            if bound and isinstance(stmt.target, ast.Name):
                # `for buf in self.moe_bufs:` — element class == bound class
                # (attr_classes records the element class of containers)
                env[stmt.target.id] = ("class", bound)
            inner = dataclasses.replace(
                ctx, env=env, while_depth=ctx.while_depth + 1)
            self._walk_body(stmt.body, inner)
            self._walk_body(stmt.orelse, ctx)
        elif isinstance(stmt, ast.Try):
            self._walk_body(stmt.body, ctx)
            for h in stmt.handlers:
                self._walk_body(h.body, ctx)
            self._walk_body(stmt.orelse, ctx)
            self._walk_body(stmt.finalbody, ctx)
        elif isinstance(stmt, ast.If):
            self._walk_expr(stmt.test, ctx, store=False)
            self._walk_body(stmt.body, ctx)
            self._walk_body(stmt.orelse, ctx)
        elif isinstance(stmt, ast.FunctionDef):
            # nested defs execute later (jit steps, worker closures): check
            # their bodies in a fresh context with nothing held
            self._walk_body(stmt.body,
                            dataclasses.replace(ctx, held=(),
                                                while_depth=0))
        elif isinstance(stmt, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
            value = getattr(stmt, "value", None)
            if value is not None:
                self._walk_expr(value, ctx, store=False)
            targets = stmt.targets if isinstance(stmt, ast.Assign) \
                else [stmt.target]
            for tgt in targets:
                self._walk_expr(tgt, ctx, store=True)
            # local bindings: `buf = self.moe_bufs[e]` / `ffn = self._m`
            if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 and \
                    isinstance(stmt.targets[0], ast.Name) and value is not None:
                self._bind_local(stmt.targets[0].id, value, ctx)
        else:
            for child in ast.iter_child_nodes(stmt):
                if isinstance(child, ast.expr):
                    self._walk_expr(child, ctx, store=False)
                elif isinstance(child, ast.stmt):
                    self._walk_stmt(child, ctx)

    def _bind_local(self, name: str, value: ast.expr, ctx: _Ctx):
        """`buf = self.moe_bufs[e]` / `ffn = self._expert_ffn_fused`."""
        if isinstance(value, ast.IfExp):
            value = value.body
        attr = is_self_attr(value, ctx.self_name)
        if attr and ctx.cm is not None and attr in ctx.cm.methods:
            ctx.env[name] = ("method", ctx.cm.name)
            return
        if isinstance(value, (ast.Subscript, ast.Attribute)):
            cls = self._resolve_class(ctx, value)
            if cls:
                ctx.env[name] = ("class", cls)

    # --------------------------------------------------- expression checks --
    def _walk_expr(self, expr: ast.expr, ctx: _Ctx, store: bool):
        # comprehension targets iterating a class-bound container get bound
        # for the whole expression (`any(f.any_set() for f in self.flags)`)
        env_add: Dict[str, Tuple[str, str]] = {}
        for node in ast.walk(expr):
            if isinstance(node, (ast.GeneratorExp, ast.ListComp,
                                 ast.SetComp, ast.DictComp)):
                for gen in node.generators:
                    if isinstance(gen.target, ast.Name):
                        cls = self._resolve_class(ctx, gen.iter)
                        if cls:
                            env_add[gen.target.id] = ("class", cls)
        if env_add:
            ctx = dataclasses.replace(ctx, env={**ctx.env, **env_add})
        for node in ast.walk(expr):
            if isinstance(node, ast.Attribute):
                self._check_attr(node, ctx)
            elif isinstance(node, ast.Call):
                self._check_call(node, ctx)
            # NOTE: lambda bodies are visited by ast.walk with the current
            # held set — correct for wait_for predicates, which run under
            # the condition's lock

    def _check_attr(self, node: ast.Attribute, ctx: _Ctx):
        attr = node.attr
        recv_self = is_self_attr(node, ctx.self_name) is not None
        if recv_self and ctx.cm is not None and attr in ctx.cm.guards:
            guard = ctx.cm.guards[attr].lock
            if guard == PROTOCOL_GUARD:
                self._finding(
                    ctx, "unguarded-access", node,
                    f"{ctx.cm.name}.{attr} is protocol-protected "
                    f"(guarded_by: protocol) — lock-free access requires an "
                    f"explicit race-ok justification")
            else:
                key = self._lock_key(ctx.cm, guard)
                if key not in ctx.held:
                    self._finding(
                        ctx, "unguarded-access", node,
                        f"{ctx.cm.name}.{attr} is guarded_by {guard} but "
                        f"accessed without holding it "
                        f"(held: {list(ctx.held) or 'nothing'})")
        elif not recv_self and attr in self.guarded_private and \
                isinstance(node.value, (ast.Name, ast.Subscript)) and \
                not (isinstance(node.value, ast.Name)
                     and node.value.id == ctx.self_name):
            owner = self.guarded_private[attr]
            here = ctx.cm.name if ctx.cm is not None else "<module>"
            if here != owner:
                self._finding(
                    ctx, "foreign-access", node,
                    f"guarded private state {owner}.{attr} accessed "
                    f"from {here} — cannot prove {owner}'s lock is "
                    f"held; add a locked accessor on {owner}")

    def _check_call(self, node: ast.Call, ctx: _Ctx):
        f = node.func
        if not isinstance(f, ast.Attribute):
            return
        attr = is_self_attr(f.value, ctx.self_name)
        # --- R3: predicate-free / unheld Condition.wait -------------------
        if f.attr == "wait" and ctx.cm is not None and attr is not None \
                and attr in ctx.cm.locks \
                and ctx.cm.locks[attr].kind == "Condition":
            key = self._lock_key(ctx.cm, attr)
            if key not in ctx.held:
                self._finding(
                    ctx, "naked-wait", node,
                    f"wait on {ctx.cm.name}.{attr} without holding it "
                    f"(RuntimeError at runtime)")
            elif ctx.while_depth == 0:
                self._finding(
                    ctx, "naked-wait", node,
                    f"{ctx.cm.name}.{attr}.wait() outside a while-predicate "
                    f"loop — spurious wakeups / lost-wakeup bug class; use "
                    f"wait_for() or re-check the predicate in a while")
        # --- lock-order: follow one level of calls ------------------------
        self._follow_call(node, ctx)

    def _follow_call(self, node: ast.Call, ctx: _Ctx):
        if len(self._chain) >= _MAX_CALL_DEPTH:
            return
        f = node.func
        target: Optional[Tuple[ClassModel, str]] = None
        if isinstance(f, ast.Attribute):
            cls = self._resolve_class(ctx, f.value)
            if cls and cls in self.registry and \
                    f.attr in self.registry[cls].methods:
                target = (self.registry[cls], f.attr)
        elif isinstance(f, ast.Name):
            b = ctx.env.get(f.id)
            if b and b[0] == "method" and b[1] in self.registry:
                # bound-method local (`ffn = self._expert_ffn_fused`): we
                # know the class but not which method — skip
                return
        if target is None:
            return
        cm, mname = target
        if (cm.name, mname) in self._chain:
            return
        fm = self.models.get(cm.path)
        if fm is None:
            return
        self._chain.append((cm.name, mname))
        try:
            fn = cm.methods[mname]
            callee_ctx = _Ctx(fm=fm, cm=cm, self_name=self._self_name(fn),
                              checking=False, held=ctx.held)
            self._walk_body(fn.body, callee_ctx)
        finally:
            self._chain.pop()

    # ------------------------------------------------------------ cycles ---
    def _detect_cycles(self):
        graph: Dict[str, Set[str]] = {}
        for (a, b) in self.edges:
            graph.setdefault(a, set()).add(b)
            graph.setdefault(b, set())
        color: Dict[str, int] = {}
        stack: List[str] = []
        cycles: List[Tuple[str, ...]] = []

        def dfs(u: str):
            color[u] = 1
            stack.append(u)
            for v in sorted(graph[u]):
                if color.get(v, 0) == 0:
                    dfs(v)
                elif color.get(v) == 1:
                    i = stack.index(v)
                    cyc = (*stack[i:], v)
                    # canonical rotation so each cycle reports once
                    base = cyc[:-1]
                    k = base.index(min(base))
                    canon = (*base[k:], *base[:k], base[k])
                    if canon not in cycles:
                        cycles.append(canon)
            stack.pop()
            color[u] = 2

        for u in sorted(graph):
            if color.get(u, 0) == 0:
                dfs(u)
        for cyc in cycles:
            wits = []
            for a, b in zip(cyc, cyc[1:]):
                wits += self.edges.get((a, b), [])[:1]
            self.findings.append(Finding(
                rule="lock-order-cycle", path=wits[0].split(":")[0]
                if wits else "<graph>",
                line=int(wits[0].rsplit(":", 1)[1].split()[0])
                if wits else 0,
                message="lock-order cycle: " + " -> ".join(cyc)
                        + " (witnesses: " + "; ".join(wits) + ")"))


def check_locks(models: Dict[str, FileModel]) -> List[Finding]:
    p = LockDisciplinePass(models)
    p.run()
    return p.findings


def lock_order_edges(models: Dict[str, FileModel]
                     ) -> Dict[Tuple[str, str], List[str]]:
    """The static lock-ordering graph alone (golden-pinned in tests)."""
    p = LockDisciplinePass(models)
    p.run()
    return p.edges
