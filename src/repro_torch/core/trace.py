"""Program spans on the profiler's clock.

The port records spans at its layer boundaries (the serving loop, the
executor's sub-layers, the prefetch worker, the waits for weights and for
device results, each weight copy) while ``torch.profiler`` records, and
only then. The switch is ``torch.autograd.profiler._is_profiler_enabled``,
the flag that a profiler's start and stop set: run the server under
``torch.profiler.profile(...)`` and the spans come with it; outside one,
each site costs one read of that flag (no clock read, no allocation, no
CUDA event).

Spans are stamped with ``time.time_ns()``, the clock Kineto stamps host
and device activity in, so a span and the profiler's trace share one
timeline: an idle gap of the card can be put down to the innermost span
it falls in.

A span holds its name, ``t0_ns`` / ``t1_ns``, the id of the span that
enclosed it on the same thread (``parent``, or None), the thread's ident
and a few attributes. ``copy.h2d`` spans also carry ``device_ns``, the
copy's own time on the card, from a pair of timing CUDA events that is
read once the events have completed (``Event.query()``), never by a
synchronize of its own.

Sites::

    sp = trace.begin("sub.attn")      # None while no profiler records
    ...
    if sp is not None:
        trace.end(sp, layer=i, source=src)

A span begun must be ended on the thread that began it; ending a span also
closes any span begun inside it that an exception left open.

The buffer is process-wide and bounded (``MAX_SPANS``); spans past the
bound are counted in ``dropped()``. ``spans()`` reads it, ``clear()``
empties it.
"""
from __future__ import annotations

import itertools
import threading
import time
from typing import List, Optional

from torch.autograd import profiler as _profiler

MAX_SPANS = 1 << 20


class Span:
    __slots__ = ("id", "name", "t0_ns", "t1_ns", "parent", "thread",
                 "attrs", "_up")

    def __init__(self, id, name, t0_ns, parent, thread, up):
        self.id = id
        self.name = name
        self.t0_ns = t0_ns
        self.t1_ns = None
        self.parent = parent          # id of the enclosing span, or None
        self.thread = thread          # threading.get_ident() of its thread
        self.attrs = {}
        self._up = up                 # the enclosing span while open

    @property
    def ns(self) -> int:
        return self.t1_ns - self.t0_ns

    def __repr__(self):
        return (f"Span({self.name!r}, {self.t0_ns}..{self.t1_ns}, "
                f"id={self.id}, parent={self.parent}, {self.attrs})")


_lock = threading.Lock()
_ids = itertools.count(1)
_local = threading.local()
_spans: List[Span] = []
_dropped = 0
# copy spans whose timing events have not completed yet: (span, start, end)
_pending: list = []


def begin(name: str) -> Optional[Span]:
    """Open span ``name`` on this thread, or None when tracing is off."""
    if not _profiler._is_profiler_enabled:
        return None
    up = getattr(_local, "open", None)
    sp = Span(next(_ids), name, time.time_ns(),
              up.id if up is not None else None, threading.get_ident(), up)
    _local.open = sp
    return sp


def end(sp: Span, **attrs):
    """Close ``sp`` with ``attrs`` and keep it."""
    global _dropped
    sp.t1_ns = time.time_ns()
    sp.attrs.update(attrs)
    _local.open, sp._up = sp._up, None
    with _lock:
        if len(_spans) < MAX_SPANS:
            _spans.append(sp)
        else:
            _dropped += 1
        if _pending:
            _resolve()


def to_host(t, what: str):
    """``t.cpu().numpy()``: the host's wait for a device result, a
    ``wait.device`` span with ``what`` while tracing."""
    sp = begin("wait.device")
    out = t.cpu().numpy()
    if sp is not None:
        end(sp, what=what)
    return out


def device_time(sp: Span, start, stop):
    """Give ``sp`` the card's time between the timing CUDA events
    ``start`` and ``stop`` (recorded on one stream) as ``device_ns``, once
    both have run."""
    with _lock:
        _pending.append((sp, start, stop))


def _resolve():
    """``device_ns`` of every pending pair that has completed (the lock
    is held)."""
    left = []
    for sp, start, stop in _pending:
        if stop.query():
            sp.attrs["device_ns"] = int(round(start.elapsed_time(stop) * 1e6))
        else:
            left.append((sp, start, stop))
    _pending[:] = left


def spans() -> List[Span]:
    """Every span kept so far, in the order they closed."""
    with _lock:
        if _pending:
            _resolve()
        return list(_spans)


def dropped() -> int:
    """Spans closed after the buffer held ``MAX_SPANS``."""
    return _dropped


def clear():
    """Empty the buffer and the dropped count."""
    global _dropped
    with _lock:
        _spans.clear()
        _pending.clear()
        _dropped = 0
