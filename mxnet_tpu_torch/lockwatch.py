"""Runtime lock-order watchdog (``MXNET_LOCK_CHECK=1``), a copy of
``mxnet_tpu/lockwatch.py`` (stdlib only).

Lock-order inversions assembled across call boundaries — thread A takes
batcher→registry while thread B takes registry→batcher — are invisible
to a lexical check.  When ``MXNET_LOCK_CHECK`` is set, ``install()``
replaces ``threading.Lock`` / ``RLock`` / ``Condition`` with thin
wrappers that

- identify every lock by its *construction site* (``file:line``), so
  all instances born at one code location collapse into one node;
- keep a thread-local stack of currently-held locks;
- on each acquisition made while another lock is held, add the edge
  ``held → acquiring`` to a global order graph; the first edge that
  closes a directed cycle raises :class:`LockCycleError` (or warns, with
  ``MXNET_LOCK_CHECK=warn``) naming both chains.

Every new edge is counted (``lockwatch.edges``), every cycle
(``lockwatch.cycles``) too, in the telemetry registry.  The port's
registry is pure Python (the reference's native one takes no Python
lock), so ``install()`` imports it before patching: the watchdog's own
sink stays unwatched, or counting an edge formed while taking its lock
would take that lock again.  Overhead is a dict update per nested
acquisition — a debug tier: the chaos harness (serve/chaos.py) exports
it to its replicas, production never sets it.  ``install()`` runs from
``mxnet_tpu_torch/__init__`` before any submodule constructs its locks;
locks created before (by other libraries) stay unwatched.
"""
from __future__ import annotations

import os
import threading
from typing import Dict, List, Optional, Set, Tuple

__all__ = ["LockCycleError", "install", "uninstall", "installed",
           "reset", "order_graph", "Watched"]

ENV = "MXNET_LOCK_CHECK"

_real_Lock = threading.Lock
_real_RLock = threading.RLock
_real_Condition = threading.Condition

_state = threading.local()          # .held: list of site ids
_graph_mu = _real_Lock()
# edge (a, b) -> (a_site, b_site, thread name) of first observation
_edges: Dict[Tuple[str, str], str] = {}
_succ: Dict[str, Set[str]] = {}
_installed = False
_mode = "raise"


class LockCycleError(RuntimeError):
    """A lock acquisition order inversion (potential ABBA deadlock)."""


def _site() -> str:
    """Construction site: first stack frame outside this module."""
    import sys
    f = sys._getframe(1)
    while f is not None and f.f_globals.get("__name__") == __name__:
        f = f.f_back
    if f is None:
        return "<unknown>"
    fn = f.f_code.co_filename
    parts = fn.replace("\\", "/").split("/")
    return "/".join(parts[-2:]) + f":{f.f_lineno}"


def _held() -> List[str]:
    h = getattr(_state, "held", None)
    if h is None:
        h = _state.held = []
    return h


def _path(a: str, b: str) -> Optional[List[str]]:
    """A directed path a → … → b in the order graph, or None."""
    seen, stack = {a}, [(a, [a])]
    while stack:
        n, p = stack.pop()
        if n == b:
            return p
        for m in _succ.get(n, ()):
            if m not in seen:
                seen.add(m)
                stack.append((m, p + [m]))
    return None


def _on_acquire(site: str):
    held = _held()
    tele, msg = (), None
    if held:
        top = held[-1]
        if top != site and (top, site) not in _edges:
            with _graph_mu:
                if (top, site) not in _edges:
                    back = _path(site, top)
                    _edges[(top, site)] = threading.current_thread().name
                    _succ.setdefault(top, set()).add(site)
                    tele = ("lockwatch.edges",)
                    if back is not None:
                        tele += ("lockwatch.cycles",)
                        msg = (
                            "lock-order inversion: this thread acquires "
                            f"{site} while holding {top}, but the order "
                            f"{' -> '.join(back)} was already observed "
                            "(ABBA deadlock risk)")
    held.append(site)
    for name in tele:           # counted after _graph_mu is released
        _tele(name)
    if msg is not None:
        if _mode == "raise":
            held.pop()
            raise LockCycleError(msg)
        import sys
        sys.stderr.write(f"[lockwatch] {msg}\n")


def _on_release(site: str):
    held = _held()
    # remove the most recent matching entry — unordered releases are
    # legal (lock A released before B even if acquired first)
    for i in range(len(held) - 1, -1, -1):
        if held[i] == site:
            del held[i]
            return


def _tele(name: str):
    try:
        from . import telemetry
        telemetry.counter_add(name)
    except Exception:
        pass        # watchdog must never die on a telemetry problem


class Watched:
    """Order-tracking proxy around one real lock instance."""

    __slots__ = ("_lk", "_lw_site", "_depth")

    def __init__(self, lk, site: str):
        self._lk = lk
        self._lw_site = site
        self._depth = 0         # reentrant acquisitions (RLock)

    def acquire(self, blocking: bool = True, timeout: float = -1):
        got = self._lk.acquire(blocking, timeout)
        if got:
            if self._depth == 0:
                try:
                    _on_acquire(self._lw_site)
                except LockCycleError:
                    # don't leave the lock wedged behind the report
                    self._lk.release()
                    raise
            self._depth += 1
        return got

    def release(self):
        self._depth -= 1
        if self._depth == 0:
            _on_release(self._lw_site)
        self._lk.release()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def locked(self):
        fn = getattr(self._lk, "locked", None)
        return fn() if fn is not None else False

    # threading.Condition(lock) pokes these on its lock argument;
    # delegate when the real lock has them (RLock), else emulate the
    # Condition fallbacks (plain Lock)
    def _release_save(self):
        depth, self._depth = self._depth, 0
        _on_release(self._lw_site)
        fn = getattr(self._lk, "_release_save", None)
        if fn is not None:
            return depth, fn()
        self._lk.release()
        return depth, None

    def _acquire_restore(self, saved):
        depth, inner = saved
        fn = getattr(self._lk, "_acquire_restore", None)
        if fn is not None:
            fn(inner)
        else:
            self._lk.acquire()
        _on_acquire(self._lw_site)
        self._depth = depth

    def _is_owned(self):
        fn = getattr(self._lk, "_is_owned", None)
        if fn is not None:
            return fn()
        if self._lk.acquire(False):
            self._lk.release()
            return False
        return True

    def _at_fork_reinit(self):
        self._depth = 0
        self._lk._at_fork_reinit()

    def __getattr__(self, name):
        # anything else (present on some lock kinds only) passes through
        return getattr(self._lk, name)

    def __repr__(self):
        return f"<Watched {self._lk!r} @ {self._lw_site}>"


def _watched_lock():
    return Watched(_real_Lock(), _site())


def _watched_rlock():
    return Watched(_real_RLock(), _site())


def _watched_condition(lock=None):
    if lock is None:
        lock = Watched(_real_RLock(), _site())
    return _real_Condition(lock)


def install(mode: Optional[str] = None) -> bool:
    """Activate the watchdog (idempotent).  ``mode`` overrides the env:
    'raise' (default) or 'warn'.  Returns True when active."""
    global _installed, _mode
    if mode is None:
        raw = os.environ.get(ENV, "").strip().lower()
        if raw in ("", "0", "false", "off"):
            return False
        mode = "warn" if raw == "warn" else "raise"
    if _installed:
        _mode = mode
        return True
    _mode = mode
    from . import telemetry  # noqa: F401 — its locks stay real (see top)
    threading.Lock = _watched_lock
    threading.RLock = _watched_rlock
    threading.Condition = _watched_condition
    _installed = True
    return True


def uninstall():
    """Restore the real factories (tests).  Existing Watched instances
    keep working; they just stop gaining company."""
    global _installed
    threading.Lock = _real_Lock
    threading.RLock = _real_RLock
    threading.Condition = _real_Condition
    _installed = False


def installed() -> bool:
    return _installed


def reset():
    """Drop the recorded order graph (tests)."""
    with _graph_mu:
        _edges.clear()
        _succ.clear()


def order_graph() -> Dict[str, Set[str]]:
    """Copy of the observed acquisition-order graph (site → successor
    sites) for assertions and post-mortems."""
    with _graph_mu:
        return {k: set(v) for k, v in _succ.items()}
