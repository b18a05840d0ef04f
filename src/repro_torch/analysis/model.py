"""Source model for the port's asaplint static passes.

Parses each file once and extracts, per class:

  * declared synchronization primitives: ``self.X = threading.Lock() /
    RLock() / Condition(...)`` anywhere in the class's methods.  A
    ``Condition(self.Y)`` built on another declared lock is recorded as an
    ALIAS of ``Y`` — holding either means holding the same underlying lock
    (the engine's ``_done_cv = threading.Condition(self._lock)`` pattern).
  * ``# guarded_by: <name>`` annotations on attribute-initializing
    assignments.  ``<name>`` is usually a declared lock/CV attribute of the
    same object; the pseudo-guard ``protocol`` marks state protected by a
    lock-free protocol instead of a lock — no ``with`` can discharge it, so
    EVERY access must carry a ``# race-ok: <reason>`` justification.
  * attribute -> class bindings, so the lock-order pass can follow
    one level of cross-object calls (``self.ex.apply_placement(...)``,
    ``self.moe_bufs[e].dispatch_send(...)``).  Bound from constructor
    parameter annotations and from ``self.X = SomeKnownClass(...)`` /
    comprehensions instantiating exactly one known class.

Per module it also records the locks bound at module level
(``_lock = threading.Lock()``), and per function what the host-sync and
launch-contract passes need: the names the function binds to tensors
(`tensor_names`), and its kernel launches (``lib.<name>_launch(...)`` on a
library from ``_build.load()``, `launch_calls`).  `wrapper_names` closes
the launching functions over module-level calls: a kernel wrapper, and
every function that reaches one by name.

CUDA sources (``.cu`` / ``.cuh``) are modelled for their ``//`` comments
only (the launch-contract pass parses their ``extern "C"`` signatures).

Suppression comments (``race-ok`` / ``sync-ok`` / ``kernel-ok`` /
``shard-ok``) are matched against the flagged node's own line and its
enclosing statement's first line.
"""
from __future__ import annotations

import ast
import dataclasses
import io
import os
import re
import tokenize
from typing import (Callable, Dict, Iterable, List, Optional, Sequence, Set,
                    Tuple)

GUARDED_RE = re.compile(r"guarded_by:\s*([A-Za-z_][A-Za-z0-9_]*)")
RACE_OK_RE = re.compile(r"race-ok:\s*(.*)")
SYNC_OK_RE = re.compile(r"sync-ok:\s*(.*)")
KERNEL_OK_RE = re.compile(r"kernel-ok:\s*(.*)")
SHARD_OK_RE = re.compile(r"shard-ok:\s*(.*)")

#: suppression kind -> regex, used by the generic accessor and the
#: stale-suppression scan (`--strict-suppressions`)
SUPPRESSION_RES: Dict[str, re.Pattern] = {
    "race-ok": RACE_OK_RE,
    "sync-ok": SYNC_OK_RE,
    "kernel-ok": KERNEL_OK_RE,
    "shard-ok": SHARD_OK_RE,
}

#: the pseudo-guard name for protocol-protected (deliberately lock-free)
#: shared state — see docs/static_analysis.md
PROTOCOL_GUARD = "protocol"

_LOCK_CTORS = {"Lock", "RLock", "Condition"}


@dataclasses.dataclass
class LockDecl:
    attr: str
    kind: str  # "Lock" | "RLock" | "Condition"
    line: int
    alias_of: Optional[str] = None  # Condition(self.Y) -> "Y"


@dataclasses.dataclass
class GuardDecl:
    attr: str
    lock: str  # lock attr name on the same object, or PROTOCOL_GUARD
    line: int


@dataclasses.dataclass
class ClassModel:
    name: str
    path: str
    node: ast.ClassDef
    locks: Dict[str, LockDecl] = dataclasses.field(default_factory=dict)
    guards: Dict[str, GuardDecl] = dataclasses.field(default_factory=dict)
    attr_classes: Dict[str, str] = dataclasses.field(default_factory=dict)
    methods: Dict[str, ast.FunctionDef] = dataclasses.field(
        default_factory=dict)

    def canonical_lock(self, attr: str) -> str:
        """Resolve alias chains: holding `_done_cv` == holding `_lock`."""
        seen = set()
        while attr in self.locks and self.locks[attr].alias_of \
                and attr not in seen:
            seen.add(attr)
            attr = self.locks[attr].alias_of
        return attr


@dataclasses.dataclass
class FileModel:
    path: str
    tree: ast.Module
    source: str
    comments: Dict[int, str]  # line -> comment text (sans leading '#')
    classes: Dict[str, ClassModel] = dataclasses.field(default_factory=dict)
    # names bound by `from x import Y` / `import x` at module level
    imports: Dict[str, str] = dataclasses.field(default_factory=dict)
    # "py", or "cu" for a CUDA source (comments only; `tree` is empty)
    lang: str = "py"
    # module-level lock names (`_lock = threading.Lock()`) -> line
    module_locks: Dict[str, int] = dataclasses.field(default_factory=dict)

    @property
    def comment_prefix(self) -> str:
        return "//" if self.lang == "cu" else "#"

    @property
    def dotted(self) -> str:
        """`.src.repro_torch.kernels._build` for that file's path."""
        return "." + _dotted_module(self.path)

    # ------------------------------------------------------- suppressions --
    def _comment_match(self, rx: re.Pattern, *lines: int):
        """Match a suppression on any of `lines`, or on a STANDALONE comment
        line block immediately above the earliest of them (inline comments on
        a preceding statement never leak downward).  Returns (match, line)
        so callers can record WHICH comment discharged the finding — the
        stale-suppression scan needs it."""
        for ln in lines:
            c = self.comments.get(ln)
            if c:
                m = rx.search(c)
                if m:
                    return m, ln
        src = self.source.splitlines()
        ln = min(lines) - 1
        while ln >= 1 and ln <= len(src) and \
                src[ln - 1].lstrip().startswith(self.comment_prefix):
            c = self.comments.get(ln)
            if c:
                m = rx.search(c)
                if m:
                    return m, ln
            ln -= 1
        return None

    def suppression(self, kind: str, *lines: int) -> Optional[Tuple[str, int]]:
        """(reason, comment_line) for a `# <kind>: reason` suppression
        covering any of `lines`, else None."""
        got = self._comment_match(SUPPRESSION_RES[kind], *lines)
        if got is None:
            return None
        m, ln = got
        return m.group(1).strip(), ln

    def race_ok(self, *lines: int) -> Optional[str]:
        got = self.suppression("race-ok", *lines)
        return got[0] if got else None

    def all_suppressions(self) -> List[Tuple[int, str, str]]:
        """Every suppression comment in the file as (line, kind, reason) —
        the universe the stale-suppression scan subtracts used ones from."""
        out: List[Tuple[int, str, str]] = []
        for ln in sorted(self.comments):
            for kind, rx in SUPPRESSION_RES.items():
                m = rx.search(self.comments[ln])
                if m:
                    out.append((ln, kind, m.group(1).strip()))
        return out


def extract_comments(source: str) -> Dict[int, str]:
    out: Dict[int, str] = {}
    try:
        for tok in tokenize.generate_tokens(io.StringIO(source).readline):
            if tok.type == tokenize.COMMENT:
                out[tok.start[0]] = tok.string.lstrip("#").strip()
    except tokenize.TokenizeError:
        pass
    return out


def scan_cu(source: str) -> Tuple[Dict[int, str], str]:
    """A CUDA source's `//` comments (line -> text) and its code with every
    comment blanked to spaces (newlines kept, so offsets map to the same
    lines).  String and character literals are skipped whole."""
    comments: Dict[int, str] = {}
    code = list(source)
    i, line, n = 0, 1, len(source)
    while i < n:
        c = source[i]
        if c == "\n":
            line += 1
        elif c in "\"'":
            j = i + 1
            while j < n and source[j] not in (c, "\n"):
                j += 2 if source[j] == "\\" else 1
            i = j if j < n and source[j] == c else j - 1
        elif source.startswith("//", i) or source.startswith("/*", i):
            block = source[i + 1] == "*"
            if block:
                j = source.find("*/", i + 2)
                j = n if j < 0 else j + 2
            else:
                j = source.find("\n", i)
                j = n if j < 0 else j
                comments[line] = source[i:j].lstrip("/").strip()
            for k in range(i, j):
                if code[k] != "\n":
                    code[k] = " "
            line += source.count("\n", i, j)
            i = j
            continue
        i += 1
    return comments, "".join(code)


#: file suffixes the passes read: Python, and CUDA sources and headers
SUFFIXES = (".py", ".cu", ".cuh")


def collect_files(paths: Sequence[str]) -> List[str]:
    files: List[str] = []
    for p in paths:
        if os.path.isdir(p):
            for root, _dirs, names in os.walk(p):
                for n in sorted(names):
                    if n.endswith(SUFFIXES):
                        files.append(os.path.join(root, n))
        elif p.endswith(SUFFIXES):
            files.append(p)
    # stable, deduped
    seen, out = set(), []
    for f in files:
        if f not in seen:
            seen.add(f)
            out.append(f)
    return out


# ---------------------------------------------------------------------------
# AST helpers
# ---------------------------------------------------------------------------


def is_self_attr(node: ast.AST, self_name: str = "self") -> Optional[str]:
    """`self.X` -> "X" (else None)."""
    if isinstance(node, ast.Attribute) and \
            isinstance(node.value, ast.Name) and node.value.id == self_name:
        return node.attr
    return None


def _threading_call(node: ast.AST) -> Optional[Tuple[str, ast.Call]]:
    """Match `threading.<Ctor>(...)` / bare `<Ctor>(...)` for lock ctors."""
    if not isinstance(node, ast.Call):
        return None
    f = node.func
    if isinstance(f, ast.Attribute) and isinstance(f.value, ast.Name) \
            and f.value.id == "threading" and f.attr in _LOCK_CTORS:
        return f.attr, node
    if isinstance(f, ast.Name) and f.id in _LOCK_CTORS:
        return f.id, node
    return None


def _find_lock_ctor(expr: ast.AST) -> Optional[Tuple[str, ast.Call]]:
    """First threading lock constructor anywhere in `expr` (handles the
    `cv if cv is not None else threading.Condition()` pattern)."""
    for sub in ast.walk(expr):
        hit = _threading_call(sub)
        if hit:
            return hit
    return None


def _first_line_with_comment(fm: FileModel, node: ast.AST,
                             rx: re.Pattern) -> Optional[re.Match]:
    """Match `rx` against comments on the node's own lines, or on a
    standalone comment block immediately above it."""
    end = getattr(node, "end_lineno", node.lineno)
    for ln in range(node.lineno, end + 1):
        c = fm.comments.get(ln)
        if c:
            m = rx.search(c)
            if m:
                return m, ln  # type: ignore[return-value]
    src = fm.source.splitlines()
    ln = node.lineno - 1
    while ln >= 1 and ln <= len(src) and \
            src[ln - 1].lstrip().startswith(fm.comment_prefix):
        c = fm.comments.get(ln)
        if c:
            m = rx.search(c)
            if m:
                return m, ln  # type: ignore[return-value]
        ln -= 1
    return None


# ---------------------------------------------------------------------------
# Model construction
# ---------------------------------------------------------------------------


def _scan_class(fm: FileModel, cnode: ast.ClassDef,
                known_classes: Iterable[str]) -> ClassModel:
    cm = ClassModel(name=cnode.name, path=fm.path, node=cnode)
    known = set(known_classes)
    for item in cnode.body:
        if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
            cm.methods[item.name] = item  # type: ignore[assignment]

    # constructor parameter annotations: `executor: DisaggregatedExecutor`
    init = cm.methods.get("__init__")
    param_types: Dict[str, str] = {}
    if init is not None:
        for a in init.args.args + init.args.kwonlyargs:
            if a.annotation is not None:
                ann = a.annotation
                if isinstance(ann, ast.Name) and ann.id in known:
                    param_types[a.arg] = ann.id
                elif isinstance(ann, ast.Constant) and \
                        isinstance(ann.value, str) and ann.value in known:
                    param_types[a.arg] = ann.value

    for fn in cm.methods.values():
        for stmt in ast.walk(fn):
            targets: List[ast.expr] = []
            value: Optional[ast.expr] = None
            if isinstance(stmt, ast.Assign):
                targets, value = stmt.targets, stmt.value
            elif isinstance(stmt, ast.AnnAssign) and stmt.value is not None:
                targets, value = [stmt.target], stmt.value
            if value is None:
                continue
            for tgt in targets:
                attr = is_self_attr(tgt)
                if attr is None:
                    continue
                # --- lock declarations --------------------------------
                hit = _find_lock_ctor(value)
                if hit and attr not in cm.locks:
                    kind, call = hit
                    alias = None
                    if kind == "Condition" and call.args:
                        alias = is_self_attr(call.args[0])
                    cm.locks[attr] = LockDecl(attr=attr, kind=kind,
                                              line=stmt.lineno,
                                              alias_of=alias)
                # --- guarded_by annotations ---------------------------
                got = _first_line_with_comment(fm, stmt, GUARDED_RE)
                if got and attr not in cm.guards:
                    m, ln = got
                    cm.guards[attr] = GuardDecl(attr=attr,
                                                lock=m.group(1), line=ln)
                # --- attr -> class bindings ---------------------------
                if attr not in cm.attr_classes:
                    bound = _bind_attr_class(value, known, param_types)
                    if bound:
                        cm.attr_classes[attr] = bound
    return cm


def _bind_attr_class(value: ast.expr, known: set,
                     param_types: Dict[str, str]) -> Optional[str]:
    """Infer the class of `self.X = <value>`: a direct known-class ctor, a
    (possibly nested) comprehension/list instantiating exactly one known
    class, or a parameter whose annotation named a known class."""
    if isinstance(value, ast.Name) and value.id in param_types:
        return param_types[value.id]
    ctors = set()
    for sub in ast.walk(value):
        if isinstance(sub, ast.Call) and isinstance(sub.func, ast.Name) \
                and sub.func.id in known:
            ctors.add(sub.func.id)
    if len(ctors) == 1:
        return ctors.pop()
    return None


def _scan_imports(tree: ast.Module) -> Dict[str, str]:
    out: Dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.module:
            for alias in node.names:
                out[alias.asname or alias.name] = node.module
        elif isinstance(node, ast.Import):
            for alias in node.names:
                out[alias.asname or alias.name.split(".")[0]] = alias.name
    return out


def _scan_module_locks(tree: ast.Module) -> Dict[str, int]:
    """Locks bound at module level: `_lock = threading.Lock()`."""
    out: Dict[str, int] = {}
    for node in tree.body:
        if isinstance(node, (ast.Assign, ast.AnnAssign)) and \
                node.value is not None and _find_lock_ctor(node.value):
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            for tgt in targets:
                if isinstance(tgt, ast.Name):
                    out[tgt.id] = node.lineno
    return out


def build_models(files: Sequence[str]) -> Dict[str, FileModel]:
    """Parse `files` into FileModels with a shared cross-file class registry
    (class names are assumed unique across the analyzed set).  A CUDA
    source gets an empty module and its `//` comments."""
    fms: Dict[str, FileModel] = {}
    class_names: List[str] = []
    for path in files:
        with open(path) as f:
            source = f.read()
        if not path.endswith(".py"):
            fms[path] = FileModel(path=path, tree=ast.Module(body=[],
                                                             type_ignores=[]),
                                  source=source,
                                  comments=scan_cu(source)[0], lang="cu")
            continue
        tree = ast.parse(source, filename=path)
        fms[path] = FileModel(path=path, tree=tree, source=source,
                              comments=extract_comments(source),
                              imports=_scan_imports(tree),
                              module_locks=_scan_module_locks(tree))
        for node in tree.body:
            if isinstance(node, ast.ClassDef):
                class_names.append(node.name)
    for path, fm in fms.items():
        for node in fm.tree.body:
            if isinstance(node, ast.ClassDef):
                fm.classes[node.name] = _scan_class(fm, node, class_names)
    return fms


def class_registry(models: Dict[str, FileModel]) -> Dict[str, ClassModel]:
    reg: Dict[str, ClassModel] = {}
    for fm in models.values():
        for name, cm in fm.classes.items():
            reg.setdefault(name, cm)
    return reg


# ---------------------------------------------------------------------------
# Tensors and kernel launches (the host-sync and launch-contract passes)
# ---------------------------------------------------------------------------

#: `torch.<sub>.*(...)` that makes no tensor: streams, events, flags, ...
_TORCH_NON_TENSOR_MODULES = {"cuda", "backends", "distributed", "profiler",
                             "utils", "_C", "jit", "library", "testing",
                             "autograd", "optim"}
#: `torch.<name>(...)` that makes no tensor
_TORCH_NON_TENSOR_CALLS = {
    "device", "Generator", "is_tensor", "is_grad_enabled",
    "is_inference_mode_enabled", "no_grad", "enable_grad", "inference_mode",
    "set_grad_enabled", "get_default_dtype", "set_default_dtype", "finfo",
    "iinfo", "manual_seed", "is_floating_point", "is_complex", "numel",
    "equal", "allclose", "promote_types", "result_type", "can_cast"}
#: tensor methods whose result is no device tensor (`.cpu()`'s is a host
#: one: what is read from it afterwards costs no further sync)
_NON_TENSOR_METHODS = {
    "item", "tolist", "numpy", "cpu", "size", "dim", "ndimension", "numel",
    "nelement", "stride", "data_ptr", "element_size", "is_contiguous",
    "is_floating_point", "is_complex", "storage_offset", "get_device",
    "equal", "allclose", "untyped_storage", "record_stream", "backward",
    "register_hook", "copy_", "__len__"}
#: tensor attributes that are tensors themselves
_TENSOR_ATTRS = {"T", "mT", "H", "mH", "real", "imag", "grad", "data"}

LAUNCH_RE = re.compile(r"^([A-Za-z0-9]\w*)_launch$")


def _dotted(node: ast.AST) -> Optional[List[str]]:
    """`a.b.c` -> ["a", "b", "c"] (None unless a chain of names)."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return parts[::-1]
    return None


def _torch_path(fm: FileModel, parts: Optional[List[str]]
                ) -> Optional[List[str]]:
    """`parts` under torch, through the file's imports: `F.softmax` with
    `import torch.nn.functional as F` -> [torch, nn, functional, F,
    softmax] (the segment after `torch` and the last are what count);
    None outside torch."""
    if not parts:
        return None
    if parts[0] == "torch":
        return parts
    mod = fm.imports.get(parts[0], "")
    if mod == "torch" or mod.startswith("torch."):
        return mod.split(".") + parts
    return None


def is_torch_call(node: ast.AST, fm: FileModel) -> bool:
    """A call into torch that returns a tensor (`torch.zeros(...)`,
    `torch.argmax(...)`, `F.softmax(...)`)."""
    if not isinstance(node, ast.Call):
        return False
    path = _torch_path(fm, _dotted(node.func))
    if path is None or len(path) < 2:
        return False
    if path[1] in _TORCH_NON_TENSOR_MODULES:
        return False
    last = path[-1]
    return last not in _TORCH_NON_TENSOR_CALLS and not last[:1].isupper()


def is_tensor_expr(node: ast.AST, names: Set[str], fm: FileModel) -> bool:
    """True when the model ties `node` to a (possibly device) tensor: a
    name in `names`, a torch call, a tensor method's tensor result, an
    index, slice or arithmetic of one."""
    if isinstance(node, ast.Name):
        return node.id in names
    if isinstance(node, ast.Call):
        if is_torch_call(node, fm):
            return True
        f = node.func
        return isinstance(f, ast.Attribute) and \
            f.attr not in _NON_TENSOR_METHODS and \
            is_tensor_expr(f.value, names, fm)
    if isinstance(node, ast.Subscript):
        return is_tensor_expr(node.value, names, fm)
    if isinstance(node, ast.Attribute):
        return node.attr in _TENSOR_ATTRS and \
            is_tensor_expr(node.value, names, fm)
    if isinstance(node, ast.BinOp):
        return is_tensor_expr(node.left, names, fm) or \
            is_tensor_expr(node.right, names, fm)
    if isinstance(node, ast.UnaryOp):
        return is_tensor_expr(node.operand, names, fm)
    if isinstance(node, ast.IfExp):
        return is_tensor_expr(node.body, names, fm) or \
            is_tensor_expr(node.orelse, names, fm)
    return False


def _names_tensor(ann: Optional[ast.expr]) -> bool:
    return ann is not None and any(
        (isinstance(n, ast.Name) and n.id == "Tensor")
        or (isinstance(n, ast.Attribute) and n.attr == "Tensor")
        for n in ast.walk(ann))


def tensor_names(fn: ast.AST, fm: FileModel) -> Set[str]:
    """The names `fn` binds to tensors: parameters annotated `Tensor`, and
    (flow-insensitively, to a fixed point) every name assigned a tensor
    expression or iterating over one -- the model's tie from a value to a
    tensor."""
    names: Set[str] = set()
    if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
        a = fn.args
        for arg in a.posonlyargs + a.args + a.kwonlyargs:
            if _names_tensor(arg.annotation):
                names.add(arg.arg)
    assigns = []
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign):
            assigns += [(t, node.value) for t in node.targets]
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            assigns.append((node.target, node.value))
        elif isinstance(node, (ast.For, ast.AsyncFor)):
            # `for row in x:` over a tensor binds its rows (tensors too)
            assigns.append((node.target, node.iter))
    changed = True
    while changed:
        changed = False
        for tgt, value in assigns:
            if not is_tensor_expr(value, names, fm):
                continue
            elts = tgt.elts if isinstance(tgt, (ast.Tuple, ast.List)) \
                else [tgt]
            for el in elts:
                if isinstance(el, ast.Name) and el.id not in names:
                    names.add(el.id)
                    changed = True
    return names


#: calls whose result lies on the host (a value read off a tensor)
_HOST_READS = {"cpu", "numpy", "tolist", "item"}


def _is_host_read(node: ast.AST) -> bool:
    """`t.cpu()`, `...numpy()`, `int(...)`, `np.asarray(...)`: a value the
    host holds, whatever it was read from."""
    if not isinstance(node, ast.Call):
        return False
    f = node.func
    if isinstance(f, ast.Attribute):
        return f.attr in _HOST_READS or (
            isinstance(f.value, ast.Name) and f.value.id in ("np", "numpy"))
    return isinstance(f, ast.Name) and f.id in ("int", "float", "bool")


def tensor_names_at(fn: ast.AST, fm: FileModel) -> Callable[[int], Set[str]]:
    """`tensor_names(fn)` as seen from a line: a name whose latest binding
    above that line read its value to the host (`first =
    first.cpu().numpy()`) holds no tensor there."""
    names = tensor_names(fn, fm)
    host_binds: Dict[str, List[Tuple[int, bool]]] = {}
    for node in ast.walk(fn):
        if isinstance(node, (ast.Assign, ast.AnnAssign)) and \
                node.value is not None:
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            host = _is_host_read(node.value)
            for tgt in targets:
                for el in (tgt.elts if isinstance(tgt, (ast.Tuple, ast.List))
                           else [tgt]):
                    if isinstance(el, ast.Name) and el.id in names:
                        host_binds.setdefault(el.id, []).append(
                            (node.lineno, host))

    def at(line: int) -> Set[str]:
        out = set()
        for n in names:
            prior = [b for b in host_binds.get(n, []) if b[0] < line]
            if not (prior and max(prior)[1]):
                out.add(n)
        return out
    return at


def is_load_call(node: ast.AST, fm: FileModel) -> bool:
    """`_build.load()` (or `load()` imported from `_build`): the call that
    builds the kernel library with nvcc at first use."""
    if not isinstance(node, ast.Call) or node.args or node.keywords:
        return False
    f = node.func
    if isinstance(f, ast.Attribute) and f.attr == "load" and \
            isinstance(f.value, ast.Name):
        mod = fm.imports.get(f.value.id, "")
        return f.value.id == "_build" or mod.split(".")[-1] == "_build"
    if isinstance(f, ast.Name) and f.id == "load":
        return fm.imports.get("load", "").split(".")[-1] == "_build"
    return False


def launch_calls(fn: ast.AST, fm: FileModel) -> List[Tuple[str, ast.Call]]:
    """(kernel, call) for every `<lib>.<kernel>_launch(...)` in `fn`, where
    `<lib>` is `_build.load()` or a name `fn` bound from it."""
    libs = {t.id for node in ast.walk(fn) if isinstance(node, ast.Assign)
            and is_load_call(node.value, fm)
            for t in node.targets if isinstance(t, ast.Name)}
    out: List[Tuple[str, ast.Call]] = []
    for node in ast.walk(fn):
        if not (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)):
            continue
        m = LAUNCH_RE.match(node.func.attr)
        recv = node.func.value
        if m and (is_load_call(recv, fm) or (isinstance(recv, ast.Name)
                                             and recv.id in libs)):
            out.append((m.group(1), node))
    return out


def _dotted_module(path: str) -> str:
    """`src/repro_torch/kernels/_build.py` -> `src.repro_torch.kernels._build`
    (matched by suffix against an import)."""
    stem = os.path.splitext(os.path.normpath(path))[0]
    parts = [p for p in stem.split(os.sep) if p not in ("", ".", "..")]
    if parts and parts[-1] == "__init__":
        parts.pop()
    return ".".join(parts)


def _module_files(models: Dict[str, FileModel], module: str) -> List[str]:
    """Analyzed files whose dotted path ends with `module`."""
    tail = "." + module
    return [p for p, fm in models.items() if fm.lang == "py" and
            fm.dotted.endswith(tail)]


def resolve_call(node: ast.Call, fm: FileModel,
                 models: Dict[str, FileModel]) -> Optional[Tuple[str, str]]:
    """(path, name) of the analyzed module-level function a call names:
    `f(...)` for an `f` defined in the file or imported from an analyzed
    module, `mod.f(...)` for an imported analyzed module `mod`."""
    f = node.func
    if isinstance(f, ast.Name):
        if any(isinstance(d, ast.FunctionDef) and d.name == f.id
               for d in fm.tree.body):
            return fm.path, f.id
        mod, name = fm.imports.get(f.id), f.id
    elif isinstance(f, ast.Attribute) and isinstance(f.value, ast.Name) \
            and f.value.id in fm.imports:
        imp = fm.imports[f.value.id]
        name = f.attr
        # `import a.b as m` binds a.b; `from a import b` binds a.b too
        for mod in (imp, f"{imp}.{f.value.id}"):
            for path in _module_files(models, mod):
                return path, name
        return None
    else:
        return None
    if mod is None:
        return None
    for path in _module_files(models, mod):
        return path, name
    return None


def wrapper_names(models: Dict[str, FileModel]) -> Set[Tuple[str, str]]:
    """(path, name) of the module-level functions that launch a kernel or
    build the library (`_build.load()`), closed over module-level calls:
    calling any of them may first build the library with nvcc."""
    fns = [(fm, node) for fm in models.values() for node in fm.tree.body
           if isinstance(node, ast.FunctionDef)]
    out = {(fm.path, node.name) for fm, node in fns
           if launch_calls(node, fm) or any(is_load_call(n, fm)
                                            for n in ast.walk(node))}
    callees = {(fm.path, node.name): {resolve_call(n, fm, models)
                                      for n in ast.walk(node)
                                      if isinstance(n, ast.Call)}
               for fm, node in fns}
    changed = True
    while changed:
        changed = False
        for fn, called in callees.items():
            if fn not in out and called & out:
                out.add(fn)
                changed = True
    return out
