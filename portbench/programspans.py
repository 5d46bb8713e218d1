"""The program's own spans (``repro_torch.core.trace``) over a run's
window, for the readers of the ``program_span`` metrics that split the
serve loop's time.

The port records spans while ``torch.profiler`` records, so a ``--trace
1`` run's window holds them and a ``--trace 0`` run's holds none. A
program without the tracer module has none either. Either way the readers
return None.
"""
from __future__ import annotations

import bisect


def window(run):
    """The spans that lie wholly in ``[run.w0_ns, run.last_ns]``, or None
    where the program has no tracer or kept no span there."""
    try:
        from repro_torch.core import trace
    except ImportError:
        return None
    out = [s for s in trace.spans()
           if s.t0_ns >= run.w0_ns and s.t1_ns <= run.last_ns]
    return out or None


def waits_under(spans, outer: str) -> dict:
    """For each span named ``outer``, by id: the ``wait.*`` spans nested
    in it on its thread (through their parents), leaving out any wait
    nested in another wait, so no host time counts twice."""
    by_id = {s.id: s for s in spans}
    out = {s.id: [] for s in spans if s.name == outer}
    for w in spans:
        if not w.name.startswith("wait."):
            continue
        p = by_id.get(w.parent)
        while p is not None and p.name != outer \
                and not p.name.startswith("wait."):
            p = by_id.get(p.parent)
        if p is not None and p.name == outer:
            out[p.id].append(w)
    return out


def decode_parts(run):
    """(decode passes, Σ ``serve.decode`` ns, Σ its ``wait.weights`` ns,
    Σ its ``wait.device`` ns) over the window, or None where it holds no
    decode pass."""
    spans = window(run)
    if spans is None:
        return None
    waits = waits_under(spans, "serve.decode")
    if not waits:
        return None
    total = sum(s.ns for s in spans if s.id in waits)
    nested = [w for ws in waits.values() for w in ws]
    return (len(waits), total,
            sum(w.ns for w in nested if w.name == "wait.weights"),
            sum(w.ns for w in nested if w.name == "wait.device"))


def copy_ns_in_decode(run):
    """(decode passes, Σ ``device_ns`` of the ``copy.h2d`` spans, of any
    thread, that start inside a ``serve.decode`` span), or None where the
    window holds no decode pass or no copy timed on the card."""
    spans = window(run)
    if spans is None:
        return None
    dec = sorted((s.t0_ns, s.t1_ns) for s in spans
                 if s.name == "serve.decode")
    timed = [s for s in spans
             if s.name == "copy.h2d" and "device_ns" in s.attrs]
    if not dec or not timed:
        return None
    starts = [a for a, _ in dec]
    ns = 0
    for c in timed:
        i = bisect.bisect_right(starts, c.t0_ns) - 1
        if i >= 0 and c.t0_ns < dec[i][1]:
            ns += c.attrs["device_ns"]
    return len(dec), ns
