"""The device trace of a ``--trace 1`` run, reduced in memory.

``torch.profiler`` records the card's activity over the measured window;
nothing is written to disk. The reduction keeps what the per-layer
readers need: kernel intervals clipped to the window and their union
(busy time; copies and memsets are the link's, not busy time), the
kernels' time by name, the time of K1's kernels, and the idle gaps
between busy intervals, each labelled by the harness's host span it fell
in.
Kineto stamps device activity in the host's wall clock (ns since the
epoch), the clock the harness stamps its spans in.
"""
from __future__ import annotations

import bisect


def start():
    from torch.profiler import ProfilerActivity, profile
    prof = profile(activities=[ProfilerActivity.CUDA])
    prof.start()
    return prof


def _kernels(prof, w0, w1):
    """The kernels' (start ns, end ns, name), clipped to [w0, w1]."""
    from torch.autograd import DeviceType
    kernels = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA or e.is_user_annotation():
            continue
        a, b = max(e.start_ns(), w0), min(e.end_ns(), w1)
        name = e.name()
        if b > a and not name.startswith(("Memcpy", "Memset")):
            kernels.append((a, b, name))
    return kernels


def _union(iv):
    """Merged busy intervals of (start, end, ...) tuples."""
    out = []
    for a, b, *_ in sorted(iv):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1][1] = b
        else:
            out.append([a, b])
    return out


def _short(name):
    """A kernel's name without its namespaces' noise, at most 120
    characters."""
    for noise in ("(anonymous namespace)::", "void ", "at::native::"):
        name = name.replace(noise, "")
    return name[:120]


def _label(spans, starts, t):
    i = bisect.bisect_right(starts, t) - 1
    if i >= 0 and t < spans[i][1]:
        return spans[i][2]
    return "between_steps"


def reduce(prof, w0, w1, spans, is_k1=lambda name: False):
    """The window's device summary. ``spans``: the harness's host spans
    (start ns, end ns, label), sorted and disjoint; ``is_k1``: whether a
    kernel's name is K1's."""
    prof.stop()
    kernels = _kernels(prof, w0, w1)
    busy = _union(kernels)
    by_name = {}
    k1_ns = 0
    for a, b, name in kernels:
        by_name[name] = by_name.get(name, 0) + (b - a)
        if is_k1(name):
            k1_ns += b - a
    starts = [s[0] for s in spans]
    gaps, prev = [], w0
    for a, b in busy + [[w1, w1]]:
        if a > prev:
            gaps.append((a - prev, _label(spans, starts, (a + prev) // 2)))
        prev = max(prev, b)
    idle_by = {}
    for g, lab in gaps:
        idle_by[lab] = idle_by.get(lab, 0) + g
    top_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    longest = sorted(gaps, reverse=True)[:max(0, 10 - len(idle_by))]
    return {
        "window_s": (w1 - w0) / 1e9,
        "busy_s": sum(b - a for a, b in busy) / 1e9,
        "kernels": len(kernels),
        "k1_s": k1_ns / 1e9,
        "device_ops": [[_short(n), t / 1e9] for n, t in top_ops],
        "idle_gaps": ([[f"all idle in {lab}", t / 1e9]
                       for lab, t in sorted(idle_by.items(),
                                            key=lambda kv: -kv[1])]
                      + [[f"one gap in {lab}", g / 1e9]
                         for g, lab in longest]),
    }
