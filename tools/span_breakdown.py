#!/usr/bin/env python3
"""A traced run of one benchmark cell, then where its serve loop's host
time went, from the port's own spans (``repro_torch.core.trace``).

    python3 tools/span_breakdown.py --workload qwen3-14b.npc4.vram50 \
        --seed 1234 --seconds 50

Runs ``portbench`` as ``portbench/run.py --trace 1`` does (its result
line is printed the same way), then prints one JSON line ``{"spans":
...}``: for decode passes (per pass) and admissions (per 1000 admitted
prompt tokens), in ms, the span's time split into host dispatch inside
``sub.attn``, inside ``sub.ffn``, inside ``sub.mamba`` (a hybrid's
Mamba-2 layers) and outside them; the waits for weights
by how they came and for the device by what was read; the copies'
time on the card, their host time and bytes by pool, and the prefetch
worker's ``prefetch.slot_wait``, each counted in the pass its span
starts in. It also gives the caching allocator's counters over the
window (``torch.cuda.memory_stats``: retries after a failed allocation,
``cudaMalloc`` and ``cudaFree`` calls, each ``cudaFree`` of a cached
block synchronizing the device), and the run's CUDA graphs of fused
decode passes (``ExecStats.decode_graph_captures`` and ``_replays``)
before the window and in it, beside the window's decode passes. Needs the
card, as a traced run does.
"""
from __future__ import annotations

import argparse
import bisect
import json
import sys
import time
from collections import defaultdict
from pathlib import Path

T_PROCESS = time.time()
ROOT = Path(__file__).resolve().parents[1]
OUTER = ("serve.admit", "serve.decode")
SUBS = ("sub.attn", "sub.ffn", "sub.mamba")
WORKER = ("copy.h2d", "prefetch.slot_wait")
ALLOCATOR = ("num_alloc_retries", "num_device_alloc", "num_device_free",
             "num_sync_all_streams")


def _ancestor(s, by_id, names):
    p = by_id.get(s.parent)
    while p is not None and p.name not in names:
        p = by_id.get(p.parent)
    return p


def breakdown(spans) -> dict:
    """The split above for each of ``OUTER``, over ``spans``."""
    by_id = {s.id: s for s in spans}
    acc = {o: defaultdict(float) for o in OUTER}
    outers = sorted((s.t0_ns, s.t1_ns, s.name) for s in spans
                    if s.name in OUTER)
    starts = [a for a, _, _ in outers]

    def add(outer, key, value):
        acc[outer][key] += value

    for s in spans:
        ms = s.ns / 1e6
        if s.name in OUTER:
            add(s.name, "span_ms", ms)
            add(s.name, "n", 1)
            add(s.name, "prompt_tokens", s.attrs.get("prompt_tokens", 0))
            add(s.name, "dispatch_outside_subs_ms", ms)
            continue
        top = _ancestor(s, by_id, OUTER)
        if top is None and s.name in WORKER:
            i = bisect.bisect_right(starts, s.t0_ns) - 1
            if i < 0 or s.t0_ns >= outers[i][1]:
                continue
            outer = outers[i][2]
        elif top is None:
            continue
        else:
            outer = top.name
        if s.name in SUBS:
            add(outer, f"dispatch_{s.name[4:]}_ms", ms)
            add(outer, "dispatch_outside_subs_ms", -ms)
        elif s.name.startswith("wait.") and \
                _ancestor(s, by_id, ("wait.weights", "wait.device")) is None:
            kind = s.attrs.get("how") or s.attrs.get("what")
            add(outer, f"{s.name}.{kind}_ms", ms)
            sub = _ancestor(s, by_id, SUBS)
            key = f"dispatch_{sub.name[4:]}_ms" if sub is not None \
                else "dispatch_outside_subs_ms"
            add(outer, key, -ms)
        elif s.name == "copy.h2d":
            pool = s.attrs["pool"]
            add(outer, f"copy.{pool}.host_ms", ms)
            add(outer, f"copy.{pool}.mb", s.attrs["bytes"] / 1e6)
            if "device_ns" in s.attrs:
                add(outer, f"copy.{pool}.device_ms",
                    s.attrs["device_ns"] / 1e6)
        elif s.name == "prefetch.slot_wait":
            add(outer, "prefetch.slot_wait_ms", ms)
    out = {}
    for outer, a in acc.items():
        n = a.pop("n", 0)
        tokens = a.pop("prompt_tokens", 0)
        per = n if outer == "serve.decode" else tokens / 1000
        if per:
            out[outer] = {"per": ("decode pass" if outer == "serve.decode"
                                  else "1000 prompt tokens"),
                          "count": n, "prompt_tokens": tokens,
                          **{k: v / per for k, v in sorted(a.items())}}
    return out


def _allocator_over_window(devtrace):
    """Wrap ``devtrace``'s window start and end to read the allocator's
    counters there; returns the dict the difference lands in."""
    import torch
    got, start, reduce = {}, devtrace.start, devtrace.reduce

    def counters():
        st = torch.cuda.memory_stats()
        return {k: st.get(k, 0) for k in ALLOCATOR}

    def start_(*a, **kw):
        got.update(counters())
        return start(*a, **kw)

    def reduce_(*a, **kw):
        now = counters()
        got.update({k: now[k] - got[k] for k in ALLOCATOR})
        return reduce(*a, **kw)
    devtrace.start, devtrace.reduce = start_, reduce_
    return got


GRAPHS = ("decode_graph_captures", "decode_graph_replays", "decode_passes")


def _graphs_over_window(devtrace):
    """Wrap the executor's constructor to find the run's executors, and
    ``devtrace``'s window start and end to read their graph counters;
    returns the dict the readings land in."""
    from repro_torch.core import executor
    made, got = [], {}
    init, start, reduce = (executor.PipelinedExecutor.__init__,
                           devtrace.start, devtrace.reduce)

    def init_(self, *a, **kw):
        init(self, *a, **kw)
        made.append(self)

    def counters():
        return {k: sum(getattr(e.stats, k, 0) for e in made) for k in GRAPHS}

    def start_(*a, **kw):
        got.update({f"{k}_before_window": v for k, v in counters().items()})
        return start(*a, **kw)

    def reduce_(*a, **kw):
        got.update({f"{k}_in_window": v - got[f"{k}_before_window"]
                    for k, v in counters().items()})
        return reduce(*a, **kw)
    executor.PipelinedExecutor.__init__ = init_
    devtrace.start, devtrace.reduce = start_, reduce_
    return got


def main(argv=None) -> int:
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from portbench import devtrace
    from portbench.harness import main as run_main
    from repro_torch.core import trace
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    a = p.parse_args(argv)
    allocator = _allocator_over_window(devtrace)
    graphs = _graphs_over_window(devtrace)
    rc = run_main(["--workload", a.workload, "--seed", str(a.seed),
                   "--seconds", str(a.seconds), "--trace", "1"],
                  t_process=T_PROCESS)
    if rc == 0:
        spans = trace.spans()
        print(json.dumps({"spans": breakdown(spans),
                          "kept": len(spans), "dropped": trace.dropped(),
                          "allocator": allocator, "graphs": graphs}))
    return rc


if __name__ == "__main__":
    sys.exit(main())
