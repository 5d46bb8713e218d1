"""Window arithmetic over a run's host stamps (ns), for the readers.

Every statistic is taken over all requests and the whole window: a
token counts when it arrived by the window's end, a request's first
token when it arrived by then."""
from __future__ import annotations

import numpy as np


def percentile(values, q):
    """The ``q``-th percentile (numpy's linear rule), or None."""
    return float(np.percentile(values, q)) if len(values) else None


def ttfts_s(run):
    return [(r.token_ns[0] - r.send_ns) / 1e9 for r in run.requests
            if r.token_ns and r.token_ns[0] <= run.end_ns]


def gaps_ms(run):
    out = []
    for r in run.requests:
        t = [x for x in r.token_ns if x <= run.end_ns]
        out.extend((b - a) / 1e6 for a, b in zip(t, t[1:]))
    return out


def tokens_in_window(run):
    return sum(sum(1 for x in r.token_ns if x <= run.end_ns)
               for r in run.requests)


def span_s(run):
    """The served span: from the window's start to the last step's end
    (the steps and counters the per-layer readers read)."""
    return (run.last_ns - run.w0_ns) / 1e9


def decode_step_ms(run):
    """Mean host time of the steps that admitted nothing."""
    d = [(s.t1_ns - s.t0_ns) / 1e6 for s in run.steps if not s.admitted]
    return sum(d) / len(d) if d else None
