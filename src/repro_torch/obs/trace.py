"""Hierarchical span tracing with Chrome trace-event export (DESIGN.md §11).

A process-wide :class:`Tracer` records *spans* — named intervals with a
category and optional args — and exports them as Chrome trace-event JSON
(the ``{"traceEvents": [...]}`` dict format) that loads directly in
Perfetto / ``chrome://tracing``.

Two kinds of time coexist in one trace:

* **wall clock** (pid 0): ``tracer.span(...)`` context-managers measure
  host time via ``perf_counter`` — planner searches, jit lowering,
  bench cells.
* **simulated time** (one pid per sim run, allocated with
  :meth:`Tracer.new_track`): the network simulator replays its virtual
  clock as explicit ``add_span(name, t0_s, t1_s)`` calls, so a
  simulated job renders as a timeline of per-level ingest /
  transport-drain lanes even though the whole thing executed in
  milliseconds of host time.

Timestamps are exported in microseconds (the trace-event unit);
fractional values are allowed and preserved.

Zero overhead when disabled: ``span()`` returns a module-level no-op
singleton without allocating, and ``add_span``/``instant`` return before
touching any state.  ``tests/test_obs.py`` pins both the zero-entry and
the zero-allocation behaviour; ``bench_sim.py``'s ``obs_overhead`` cell
floor-gates the throughput of the disabled path in CI.

Stdlib-only on purpose: every layer (core, net, train, tools) may import
this module without creating cycles or dragging in jax.
"""

from __future__ import annotations

import contextlib
import json
import time
from typing import Any, Iterator, Optional

__all__ = [
    "Tracer",
    "get_tracer",
    "set_tracer",
    "scoped_tracer",
    "enable",
    "disable",
]

#: wall-clock track: every ``span()`` context-manager lands here.
WALL_PID = 0
#: first pid handed out by :meth:`Tracer.new_track` for virtual-time tracks.
_FIRST_TRACK_PID = 1


class _NullSpan:
    """No-op context manager returned by a disabled tracer (singleton)."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class _Span:
    """Live wall-clock span; appends one complete ("X") event on exit."""

    __slots__ = ("_tracer", "_name", "_cat", "_args", "_tid", "_t0")

    def __init__(self, tracer, name, cat, args, tid):
        self._tracer = tracer
        self._name = name
        self._cat = cat
        self._args = args
        self._tid = tid
        self._t0 = time.perf_counter()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        tr = self._tracer
        t0 = (self._t0 - tr._epoch) * 1e6
        dur = (time.perf_counter() - self._t0) * 1e6
        ev = {"name": self._name, "cat": self._cat, "ph": "X",
              "ts": t0, "dur": dur, "pid": WALL_PID, "tid": self._tid}
        if self._args:
            ev["args"] = self._args
        tr.events.append(ev)
        return False


class Tracer:
    """Collects trace events; exports Chrome trace-event JSON.

    Disabled by default.  All record methods are no-ops while disabled;
    ``enable()``/``disable()`` flip recording without losing prior events.
    """

    def __init__(self, enabled: bool = False):
        self.enabled = bool(enabled)
        self.events: list[dict] = []
        self._epoch = time.perf_counter()
        self._next_pid = _FIRST_TRACK_PID
        self._meta: list[dict] = []

    # -- lifecycle ---------------------------------------------------------
    def enable(self) -> None:
        self.enabled = True

    def disable(self) -> None:
        self.enabled = False

    def clear(self) -> None:
        self.events.clear()
        self._meta.clear()
        self._next_pid = _FIRST_TRACK_PID
        self._epoch = time.perf_counter()

    # -- recording ---------------------------------------------------------
    def span(self, name: str, cat: str = "wall", args: Optional[dict] = None,
             tid: int = 0):
        """Wall-clock span context manager (no-op singleton when disabled)."""
        if not self.enabled:
            return _NULL_SPAN
        return _Span(self, name, cat, args, tid)

    def add_span(self, name: str, t0_s: float, t1_s: float, *,
                 cat: str = "sim", pid: int = WALL_PID, tid: int = 0,
                 args: Optional[dict] = None) -> None:
        """Record a span with explicit start/end times in *seconds*.

        Used by the simulator to replay virtual time: ``t0_s``/``t1_s``
        are simulated seconds, exported as microseconds on track ``pid``.
        """
        if not self.enabled:
            return
        ev = {"name": name, "cat": cat, "ph": "X", "ts": t0_s * 1e6,
              "dur": max(t1_s - t0_s, 0.0) * 1e6, "pid": pid, "tid": tid}
        if args:
            ev["args"] = args
        self.events.append(ev)

    def add_wall_span(self, name: str, t0_perf: float, t1_perf: float, *,
                      cat: str = "wall", tid: int = 0,
                      args: Optional[dict] = None) -> None:
        """Record a wall-clock span from explicit ``perf_counter`` stamps
        (for callers that measured before deciding to record)."""
        if not self.enabled:
            return
        ev = {"name": name, "cat": cat, "ph": "X",
              "ts": (t0_perf - self._epoch) * 1e6,
              "dur": max(t1_perf - t0_perf, 0.0) * 1e6,
              "pid": WALL_PID, "tid": tid}
        if args:
            ev["args"] = args
        self.events.append(ev)

    def instant(self, name: str, *, t_s: Optional[float] = None,
                cat: str = "wall", pid: int = WALL_PID, tid: int = 0,
                args: Optional[dict] = None) -> None:
        """Record an instant ("i") event; wall-clock 'now' if t_s is None."""
        if not self.enabled:
            return
        ts = ((time.perf_counter() - self._epoch) if t_s is None else t_s)
        ev = {"name": name, "cat": cat, "ph": "i", "s": "t",
              "ts": ts * 1e6, "pid": pid, "tid": tid}
        if args:
            ev["args"] = args
        self.events.append(ev)

    def new_track(self, name: str) -> int:
        """Allocate a fresh pid for a virtual-time track (e.g. one sim job).

        Each simulated job gets its own track so repeated runs never
        interleave partially-overlapping spans on one lane — nesting per
        (pid, tid) stays well-formed by construction.
        """
        pid = self._next_pid
        self._next_pid += 1
        self._meta.append({"name": "process_name", "ph": "M", "pid": pid,
                           "tid": 0, "args": {"name": name}})
        return pid

    def name_thread(self, pid: int, tid: int, name: str) -> None:
        """Attach a human-readable lane name to (pid, tid)."""
        if not self.enabled:
            return
        self._meta.append({"name": "thread_name", "ph": "M", "pid": pid,
                           "tid": tid, "args": {"name": name}})

    # -- export ------------------------------------------------------------
    def to_chrome(self) -> dict:
        """Chrome trace-event JSON dict (loads in Perfetto)."""
        meta = [{"name": "process_name", "ph": "M", "pid": WALL_PID,
                 "tid": 0, "args": {"name": "wall-clock"}}]
        return {"traceEvents": meta + self._meta + self.events,
                "displayTimeUnit": "ms"}

    def write(self, path) -> None:
        with open(path, "w") as f:
            json.dump(self.to_chrome(), f)


# -- process-wide default --------------------------------------------------

_TRACER = Tracer()


def get_tracer() -> Tracer:
    """The process-wide tracer (disabled until someone calls enable())."""
    return _TRACER


def set_tracer(tracer: Tracer) -> Tracer:
    """Replace the process-wide tracer; returns the previous one."""
    global _TRACER
    prev, _TRACER = _TRACER, tracer
    return prev


@contextlib.contextmanager
def scoped_tracer(tracer: Optional[Tracer] = None) -> Iterator[Tracer]:
    """Temporarily install ``tracer`` (a fresh enabled one by default)."""
    t = Tracer(enabled=True) if tracer is None else tracer
    prev = set_tracer(t)
    try:
        yield t
    finally:
        set_tracer(prev)


def enable() -> Tracer:
    _TRACER.enable()
    return _TRACER


def disable() -> Tracer:
    _TRACER.disable()
    return _TRACER
