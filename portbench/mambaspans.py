"""The port's ``sub.mamba`` spans (a patterned hybrid's Mamba-2
sub-layers, ``repro_torch.core.trace``) under the serve loop's spans, for
the readers of the Mamba-2 metrics. A run with no such span, or no
tracer, reads None (``programspans.window``)."""
from __future__ import annotations

from portbench import programspans


def mamba_under(run, outer: str):
    """(the ``outer`` spans of the window, Σ ns of the ``sub.mamba`` spans
    nested in them), or None where the window holds no ``sub.mamba`` span
    inside an ``outer`` one."""
    spans = programspans.window(run)
    if spans is None:
        return None
    by_id = {s.id: s for s in spans}
    outers = [s for s in spans if s.name == outer]
    ns, found = 0, False
    for s in spans:
        if s.name != "sub.mamba":
            continue
        p = by_id.get(s.parent)
        while p is not None and p.name != outer:
            p = by_id.get(p.parent)
        if p is not None:
            ns += s.ns
            found = True
    return (outers, ns) if found else None
