"""Runtime lockdep sanitizer (asaplint pass 3 of the port; the reference's,
with the same creation-site classes and rules).

Linux-lockdep in miniature for the threaded MPMD runtime: `install()`
monkeypatches `threading.Lock` / `threading.RLock` / `threading.Condition`
so that locks CREATED FROM THIS REPO'S CODE (the creation site is filtered
by filename — torch/pytest/stdlib internals are left untouched) are wrapped
with bookkeeping that

  * records, per thread, the ordered stack of held instrumented locks;
  * learns the global lock order from the first witnessed nesting
    (`A held while acquiring B` adds edge A->B); acquiring in the REVERSE
    direction of a learned edge — from any thread, at any later time — is
    an order violation (the classic ABBA deadlock, caught without needing
    the unlucky interleaving);
  * flags a blocking `Condition.wait()` / `wait_for()` issued while
    holding any OTHER instrumented lock (the waiter sleeps with a lock the
    waker may need).  Waiting on the condition's own underlying lock is the
    normal protocol and exempt — including aliases like the engine's
    `_done_cv = Condition(self._lock)`.

Violations are recorded (with both stacks' creation sites) and, by
default, also raised at the offending call so tests fail loudly.  The
whole thing is refcounted: nested `install()`s are cheap, and
`uninstall()` restores the real `threading` classes.

Use the `lockdep_active()` context manager: the port's tests wrap the
executor, its buffers and its engine in it, and `chip_smoke.py` the serve
wave on the card.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import sys
import threading
from typing import Dict, List, Optional, Set, Tuple

#: repo root used to decide which lock creation sites get instrumented
REPO_ROOT = os.path.dirname(  # .../src/repro_torch/analysis -> repo root
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

_REAL_LOCK = threading.Lock
_REAL_RLOCK = threading.RLock
_REAL_CONDITION = threading.Condition

_state_lock = _REAL_LOCK()  # protects the module-level tables below
_install_count = 0
_next_id = 0

# learned order: (a_site, b_site) -> witness description.  Keyed by creation
# site (file:line) so all locks born at one site share an order class, like
# lockdep's lock classes — per-element buffer locks from one comprehension
# don't explode the graph.
_edges: Dict[Tuple[str, str], str] = {}
_violations: List["Violation"] = []
# creation sites of the locks and conditions instrumented since the last
# reset(): what a clean run actually covered
_sites: Set[str] = set()

#: raise at the offending acquire/wait (True in tests); False = record only
RAISE_ON_VIOLATION = True

_tls = threading.local()


class LockOrderViolation(RuntimeError):
    pass


@dataclasses.dataclass
class Violation:
    kind: str  # "order-inversion" | "held-lock-wait"
    message: str
    thread: str


def _held() -> List["_DepLock"]:
    if not hasattr(_tls, "stack"):
        _tls.stack = []
    return _tls.stack


def _creation_site() -> Optional[str]:
    """file:line of the nearest repo-owned (non-analysis) caller frame."""
    f = sys._getframe(2)
    while f is not None:
        fn = f.f_code.co_filename
        if fn.startswith(REPO_ROOT) and os.sep + "analysis" + os.sep not in fn \
                and "threading" not in os.path.basename(fn):
            rel = os.path.relpath(fn, REPO_ROOT)
            if not rel.startswith(".."):
                return f"{rel}:{f.f_lineno}"
        f = f.f_back
    return None


def _record_violation(kind: str, message: str):
    v = Violation(kind=kind, message=message,
                  thread=threading.current_thread().name)
    with _state_lock:
        _violations.append(v)
    if RAISE_ON_VIOLATION:
        raise LockOrderViolation(f"[{kind}] {message}")


def _check_order(new: "_DepLock"):
    stack = _held()
    for holder in stack:
        if holder.site == new.site:
            continue  # same order class (e.g. sibling buffer locks)
        fwd = (holder.site, new.site)
        rev = (new.site, holder.site)
        with _state_lock:
            if rev in _edges:
                witness = _edges[rev]
                msg = (f"lock order inversion: acquiring {new.name} "
                       f"({new.site}) while holding {holder.name} "
                       f"({holder.site}), but the reverse order was "
                       f"established at {witness}")
                inverted = True
            else:
                inverted = False
                if fwd not in _edges:
                    _edges[fwd] = (f"{threading.current_thread().name} in "
                                   f"{_caller_site()}")
        if inverted:
            _record_violation("order-inversion", msg)


def _caller_site() -> str:
    f = sys._getframe(2)
    while f is not None:
        fn = f.f_code.co_filename
        if fn.startswith(REPO_ROOT) and os.sep + "analysis" + os.sep not in fn:
            return f"{os.path.relpath(fn, REPO_ROOT)}:{f.f_lineno}"
        f = f.f_back
    return "<unknown>"


class _DepLock:
    """Wrapper around a real Lock/RLock with lockdep bookkeeping."""

    def __init__(self, inner, kind: str, site: Optional[str]):
        self._inner = inner
        self.kind = kind
        self.site = site or "<untracked>"
        self.instrumented = site is not None
        global _next_id
        with _state_lock:
            _next_id += 1
            self.name = f"{kind}#{_next_id}"
            if site is not None:
                _sites.add(site)
        self._depth = 0  # reentrant depth (RLock); guarded by ownership

    # -- acquisition ------------------------------------------------------
    def acquire(self, blocking: bool = True, timeout: float = -1):
        if self.instrumented and blocking:
            if not (self.kind == "RLock" and self._owned_by_me()):
                _check_order(self)
        if timeout == -1:
            got = self._inner.acquire(blocking)
        else:
            got = self._inner.acquire(blocking, timeout)
        if got and self.instrumented:
            self._push()
        return got

    def release(self):
        if self.instrumented:
            self._pop()
        self._inner.release()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    # -- bookkeeping ------------------------------------------------------
    def _owned_by_me(self) -> bool:
        return any(lk is self for lk in _held())

    def _push(self):
        _held().append(self)
        self._depth += 1

    def _pop(self):
        stack = _held()
        # release order need not be LIFO; remove the most recent entry
        for i in range(len(stack) - 1, -1, -1):
            if stack[i] is self:
                del stack[i]
                break
        self._depth -= 1

    # threading.Condition(lock) probes these
    def _is_owned(self):
        return self._inner._is_owned() if hasattr(self._inner, "_is_owned") \
            else not self._inner.acquire(False) or (self._inner.release()
                                                    or False)

    def _release_save(self):
        if self.instrumented:
            self._pop()
        return self._inner.release()

    def _acquire_restore(self, state):
        self._inner.acquire()
        if self.instrumented:
            self._push()

    def locked(self):
        return self._inner.locked() if hasattr(self._inner, "locked") else None

    def __repr__(self):
        return f"<DepLock {self.name} @ {self.site}>"


def _make_lock_factory(kind: str, real_ctor):
    def factory(*a, **kw):
        return _DepLock(real_ctor(*a, **kw), kind, _creation_site())
    return factory


class _DepCondition(_REAL_CONDITION):
    """Condition whose waits are checked for held-lock blocking.

    Subclasses the real Condition so isinstance checks and the full
    notify/wait protocol keep working.  If built without an explicit lock
    it creates (and instruments, when the creation site is in-repo) its own
    RLock, matching the stdlib default.
    """

    def __init__(self, lock=None):
        site = _creation_site()
        if lock is None:
            lock = _DepLock(_REAL_RLOCK(), "RLock", site)
        super().__init__(lock)
        self._dep_site = site
        if site is not None:
            with _state_lock:
                _sites.add(site)

    def _check_wait(self, timeout):
        own = self._lock if isinstance(self._lock, _DepLock) else None
        held = [lk for lk in _held() if lk is not own]
        if held and (timeout is None or timeout > 0.05):
            holder = held[-1]
            _record_violation(
                "held-lock-wait",
                f"blocking Condition.wait (cv @ "
                f"{self._dep_site or '<untracked>'}) while holding "
                f"{holder.name} ({holder.site}) — the waker may need that "
                f"lock to make progress")

    def wait(self, timeout=None):
        if self._dep_site is not None:
            self._check_wait(timeout)
        return super().wait(timeout)

    # wait_for loops over wait(); checking wait() covers it.


def install():
    """Monkeypatch threading's lock classes (refcounted)."""
    global _install_count
    with _state_lock:
        _install_count += 1
        if _install_count > 1:
            return
    threading.Lock = _make_lock_factory("Lock", _REAL_LOCK)
    threading.RLock = _make_lock_factory("RLock", _REAL_RLOCK)
    threading.Condition = _DepCondition


def uninstall():
    global _install_count
    with _state_lock:
        if _install_count == 0:
            return
        _install_count -= 1
        if _install_count:
            return
    threading.Lock = _REAL_LOCK
    threading.RLock = _REAL_RLOCK
    threading.Condition = _REAL_CONDITION


def reset():
    """Clear learned edges, recorded violations and instrumented sites (NOT
    the install state)."""
    with _state_lock:
        _edges.clear()
        _violations.clear()
        _sites.clear()
    _tls.stack = []


def violations() -> List[Violation]:
    with _state_lock:
        return list(_violations)


def learned_edges() -> Dict[Tuple[str, str], str]:
    with _state_lock:
        return dict(_edges)


def instrumented_sites() -> Set[str]:
    """Creation sites (file:line) of the locks and conditions instrumented
    since the last reset()."""
    with _state_lock:
        return set(_sites)


def active() -> bool:
    with _state_lock:
        return _install_count > 0


@contextlib.contextmanager
def lockdep_active(raise_on_violation: bool = True):
    """Context manager: instrument, run, restore.

    With raise_on_violation=False violations are recorded instead of
    raised — inspect them with `violations()` after the block.
    """
    global RAISE_ON_VIOLATION
    prev = RAISE_ON_VIOLATION
    RAISE_ON_VIOLATION = raise_on_violation
    install()
    try:
        yield
    finally:
        uninstall()
        RAISE_ON_VIOLATION = prev
