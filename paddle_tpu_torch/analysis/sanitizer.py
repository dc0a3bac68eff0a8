"""Runtime sanitizer mode (``FLAGS_sanitize``) for the serving stack
(counterpart: paddle_tpu/analysis/sanitizer.py).

One flag turns it on, and it is near-free when off:

* **lock-order cycles** — the designated telemetry locks are
  `TrackedLock` wrappers under the JAX package's lock names; while the
  sanitizer is active every acquisition records (held -> acquiring)
  edges in a process-wide order graph, and the edge that closes a cycle
  raises `LockOrderError` at the acquisition that would have deadlocked;
* **warm retraces raise** — a `serving._StepGraph` that meets a new step
  signature after its first call (the tracker is warm) raises
  `WarmRetraceError` instead of counting ``retraces_after_warmup``: the
  zero-warm-retrace contract becomes an assertion;
* **host-sync sentinel** — the engine's blocking device reads
  (`DecodeEngine._fetch`) are counted, and so are its steps, so a step
  that silently grew a second sync shows up in `report()` as
  ``host_syncs > steps``;
* **the pool audit** — every step boundary runs
  `KVBlockPool.assert_consistent` over the live requests' pages (what
  ``FLAGS_kv_pool_debug`` runs alone).

There is no donation check: JAX donates a step's pools to the jitted
call and a later read of the donated buffer is the bug its tombstones
catch, while the port's steps write their pools in place.
`UseAfterDonateError` keeps its name so ``except`` sites read as in the
JAX package; nothing raises it, and ``report()["tombstoned_buffers"]``
is always 0.

Everything routes through `active()`: ``None`` when the flag is off (one
dict lookup on the hot path), the process `Sanitizer` otherwise.  This
module imports only the standard library, so the telemetry modules build
their `TrackedLock`s at import time without ordering constraints; the
flag registry is looked up the first time `active()` runs.
"""
from __future__ import annotations

import threading
from typing import Optional

__all__ = [
    "SanitizerError", "UseAfterDonateError", "LockOrderError",
    "WarmRetraceError", "Sanitizer", "TrackedLock", "active", "get",
    "reset",
]


class SanitizerError(RuntimeError):
    """Base class: every sanitizer failure is loud and typed."""


class UseAfterDonateError(SanitizerError):
    """The JAX package's use-after-donate failure.  The port writes its
    pools in place and donates nothing, so nothing raises this."""


class LockOrderError(SanitizerError):
    """Two designated locks were acquired in both orders — a latent
    deadlock."""


class WarmRetraceError(SanitizerError):
    """A warm step tracker met a new signature mid-serve (the
    zero-warm-retrace contract, promoted from counter to assertion)."""


# the flag registry, looked up once: `active()` reads it directly (one
# dict lookup, no cached copy), so a `set_flags` is seen at once
_STATE = {"reg": None}


def _install() -> bool:
    if _STATE["reg"] is not None:
        return True
    try:
        from ..core import flags as _flags

        _flags.flag("sanitize")
        _STATE["reg"] = _flags._REGISTRY
    except Exception:
        return False
    return True


class Sanitizer:
    """Process-wide sanitizer state: the lock-order graph and the
    counters.  All methods are thread-safe (the engine steps on a worker
    thread under `ServingFrontend`)."""

    def __init__(self):
        self._mu = threading.Lock()  # guards the graph and the counters
        self._tls = threading.local()
        self.lock_edges = {}
        self.host_syncs = 0
        self.steps = 0
        self.warm_retraces = 0

    def reset(self):
        """Drop all recorded global state (test isolation).  Per-thread
        held-lock stacks are not touched: release bookkeeping runs even
        while the sanitizer is off, so they maintain themselves."""
        with self._mu:
            self.lock_edges = {}
            self.host_syncs = 0
            self.steps = 0
            self.warm_retraces = 0

    # -- counters ------------------------------------------------------------
    def count_step(self):
        with self._mu:
            self.steps += 1

    def count_host_sync(self):
        with self._mu:
            self.host_syncs += 1

    def count_warm_retrace(self, n=1):
        with self._mu:
            self.warm_retraces += n

    def report(self) -> dict:
        with self._mu:
            return {
                "steps": self.steps,
                "host_syncs": self.host_syncs,
                "warm_retraces": self.warm_retraces,
                "lock_edges": sorted(self.lock_edges),
                "tombstoned_buffers": 0,
            }

    # -- lock-order tracking -------------------------------------------------
    def _held(self):
        h = getattr(self._tls, "held", None)
        if h is None:
            h = self._tls.held = []
        return h

    def note_acquire(self, name: str, reentrant: bool = True):
        """Record that this thread is about to acquire ``name``.  Adds
        (held -> name) edges for every lock it holds; an edge that closes
        a cycle raises before the acquisition blocks.  ``reentrant=False``
        (a plain Lock): re-acquiring a lock this thread holds is a certain
        self-deadlock and raises at once."""
        held = self._held()
        if name in held:
            if not reentrant:
                raise LockOrderError(
                    f"self-deadlock: thread already holds non-"
                    f"reentrant lock {name!r} and is acquiring it "
                    f"again — this blocks forever")
            held.append(name)  # RLock: no new ordering information
            return
        if held:
            with self._mu:
                for h in dict.fromkeys(held):
                    if (h, name) not in self.lock_edges:
                        cycle = self._path(name, h)
                        if cycle is not None:
                            # the cycle-closing edge is not recorded: the
                            # next inverted acquisition must raise again
                            raise LockOrderError(
                                "lock-order cycle: acquiring "
                                f"{name!r} while holding {h!r}, but the "
                                "opposite order was already observed "
                                f"(path {' -> '.join([h, name] + cycle[1:])})"
                            )
                        self.lock_edges[(h, name)] = True
        held.append(name)

    def note_release(self, name: str):
        held = self._held()
        if held and held[-1] == name:
            held.pop()
        elif name in held:  # out-of-order release
            held.remove(name)

    def _path(self, start: str, target: str) -> Optional[list]:
        """Path start -> ... -> target in the edge graph, or None.
        Caller holds self._mu."""
        stack = [(start, [start])]
        seen = set()
        while stack:
            node, path = stack.pop()
            if node == target:
                return path
            if node in seen:
                continue
            seen.add(node)
            for (a, b) in self.lock_edges:
                if a == node:
                    stack.append((b, path + [b]))
        return None


_SAN = Sanitizer()


def get() -> Sanitizer:
    """The process sanitizer (its state reads even while disabled)."""
    return _SAN


def active() -> Optional[Sanitizer]:
    """The process `Sanitizer` when FLAGS_sanitize is on, else None."""
    reg = _STATE["reg"]
    if reg is None:
        if not _install():
            return None
        reg = _STATE["reg"]
    return _SAN if reg["sanitize"] else None


def reset():
    _SAN.reset()


class TrackedLock:
    """Drop-in wrapper over a ``threading.Lock``/``RLock``: delegates
    acquire/release and, while the sanitizer is active, records the
    acquisition order into the process-wide graph (cycles raise
    `LockOrderError`).  Off, it costs one dict lookup an acquisition."""

    __slots__ = ("_inner", "name", "_reentrant")
    # held on the class: a weakref callback that takes a lock while the
    # interpreter exits may run after this module's globals are cleared
    _state = _STATE
    _san = _SAN

    @classmethod
    def _active(cls) -> Optional[Sanitizer]:
        """`active()`, through the class's own references."""
        reg = cls._state["reg"]
        if reg is None:
            return active()
        return cls._san if reg["sanitize"] else None

    def __init__(self, inner, name: str):
        self._inner = inner
        self.name = name
        self._reentrant = isinstance(inner, type(threading.RLock()))

    def acquire(self, *args, **kwargs):
        san = self._active()
        if san is not None:
            # record (and cycle-check) before the acquisition can block
            san.note_acquire(self.name, reentrant=self._reentrant)
        try:
            ok = self._inner.acquire(*args, **kwargs)
        except BaseException:
            self._san.note_release(self.name)
            raise
        if not ok:
            # a failed non-blocking try holds nothing
            self._san.note_release(self.name)
        return ok

    def release(self):
        # runs whether or not the sanitizer is on: a flag flipped off
        # between acquire and release must not leave a stale entry
        self._san.note_release(self.name)
        return self._inner.release()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def __repr__(self):
        return f"TrackedLock({self.name!r}, {self._inner!r})"

