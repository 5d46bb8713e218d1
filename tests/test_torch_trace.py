"""The port's spans (``repro_torch.core.trace``) over a tiny dense serve on
the CPU: none while no profiler records; under ``torch.profiler`` they
nest as the serving loop, the executor and the prefetch worker nest, the
waits lie inside the serve spans of the serving thread, the worker's
copies and slot waits on its own thread, the three parts of a decode pass
add up to it, at-use waits appear exactly when at-use bytes moved, and
Kineto's own op events fall inside the spans of their pass (one clock).
"""
import threading
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import Session
from repro_torch.configs import get_smoke_config
from repro_torch.core import (CLI2, InferenceSetting, build_graph,
                              run_install, total_weight_bytes, trace)
from repro_torch.core.serving import Request
from repro_torch.models import build_model

torch.set_num_threads(1)

MAX_SEQ, MAX_BATCH = 48, 2
# 2.0x: all pinned; 0.5x: streamed FFNs and at-use attention; 0.1x: more
BUDGETS = (2.0, 0.5, 0.1)
WAITS = ("wait.weights", "wait.device")
# each span's possible parents (None: outermost on its thread)
PARENTS = {
    "serve.step": {None},
    "serve.admit": {"serve.step"},
    "serve.decode": {"serve.step"},
    "sub.attn": {"serve.admit", "serve.decode"},
    "sub.ffn": {"serve.admit", "serve.decode"},
    "wait.weights": {"sub.attn", "sub.ffn"},
    "wait.device": {"serve.admit", "serve.decode", "sub.attn", "sub.ffn"},
    "copy.h2d": {None, "wait.weights"},
    "prefetch.slot_wait": {None},
}


@pytest.fixture(scope="module")
def model():
    cfg = get_smoke_config("qwen2-0.5b")
    params = build_model(cfg).init(torch.Generator().manual_seed(0))
    return cfg, params, run_install(CLI2, quick=True), \
        total_weight_bytes(build_graph(cfg))


def _serve(model, frac, traced):
    cfg, params, db, total = model
    sess = Session.open(cfg, CLI2, int(total * frac) + 1,
                        InferenceSetting(batch=MAX_BATCH, context=MAX_SEQ),
                        db=db, params=params, max_seq=MAX_SEQ, device="cpu")
    rng = np.random.RandomState(0)
    reqs = [Request(rid=i, prompt=rng.randint(0, cfg.vocab, size=5 + 7 * i)
                    .astype(np.int32), max_new_tokens=6) for i in range(3)]
    trace.clear()
    prof = None
    if traced:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            sess.serve(reqs, max_batch=MAX_BATCH)
    else:
        sess.serve(reqs, max_batch=MAX_BATCH)
    return sess, trace.spans(), prof


def _outer(s, by_id, names):
    """The nearest enclosing span of ``s`` named in ``names``, or None."""
    p = by_id.get(s.parent)
    while p is not None and p.name not in names:
        p = by_id.get(p.parent)
    return p


def test_no_spans_without_a_profiler(model):
    sess, spans, _ = _serve(model, 0.1, traced=False)
    assert sess.stats()["executor"]["staged_bytes"] > 0
    assert spans == [] and trace.dropped() == 0


@pytest.mark.parametrize("frac", BUDGETS)
def test_spans_nest_and_threads(model, frac):
    sess, spans, _ = _serve(model, frac, traced=True)
    ex = sess.stats()["executor"]
    main = threading.get_ident()
    by_id = {s.id: s for s in spans}
    assert len(by_id) == len(spans)
    assert {s.name for s in spans} <= set(PARENTS)
    for s in spans:
        parent = by_id.get(s.parent)
        assert s.parent is None or parent is not None, s
        assert (parent.name if parent else None) in PARENTS[s.name], s
        if parent is not None:
            assert parent.thread == s.thread
            assert parent.t0_ns <= s.t0_ns <= s.t1_ns <= parent.t1_ns
    for s in spans:
        if s.name.startswith(("wait.", "serve.", "sub.")):
            assert s.thread == main, s
        if s.name.startswith("wait."):
            assert _outer(s, by_id, ("serve.admit", "serve.decode")), s
        if s.name == "prefetch.slot_wait" or (
                s.name == "copy.h2d" and s.attrs["pool"] == "static"):
            assert s.thread != main, s
        if s.name == "copy.h2d" and s.attrs["pool"] == "at_use":
            assert by_id[s.parent].attrs["how"] == "at_use"
            assert by_id[s.parent].attrs["bytes"] == s.attrs["bytes"] > 0
    names = [s.name for s in spans]
    assert names.count("serve.step") == sess.stats()["serving"]["iterations"]
    assert names.count("serve.admit") == 3
    layers = sess.cfg.n_layers
    passes = names.count("serve.admit") + names.count("serve.decode")
    assert names.count("sub.attn") == names.count("sub.ffn") \
        == layers * passes
    streamed = [s for s in spans if s.name == "sub.ffn"
                and s.attrs["source"] == "streamed"]
    copies = [s for s in spans if s.name == "copy.h2d"
              and s.attrs["pool"] == "static"]
    # the static pool copies every sub-layer streamed in a pass, once
    assert len(copies) == len([s for s in spans if s.name.startswith("sub.")
                               and s.attrs["source"] == "streamed"])
    assert (len(streamed) > 0) == (ex["streamed_bytes"] > 0)
    assert sum(s.attrs["bytes"] for s in spans if s.name == "copy.h2d") \
        == ex["staged_bytes"]
    at_use = [s for s in spans if s.name == "wait.weights"
              and s.attrs["how"] == "at_use"]
    assert (len(at_use) > 0) == (ex["at_use_bytes"] > 0)


@pytest.mark.parametrize("frac", BUDGETS)
def test_decode_parts_add_up(model, frac):
    """Each decode pass is its host dispatch plus its waits: the waits
    that lie in it on the serving thread, none inside another, do not
    overlap, and the benchmark's readers (which walk the spans' parents)
    find the same sums, so dispatch + weight waits + device waits is the
    mean ``serve.decode`` span exactly."""
    from portbench import programspans, spec
    _, spans, _ = _serve(model, frac, traced=True)
    decodes = [s for s in spans if s.name == "serve.decode"]
    waits = [w for w in spans if w.name in WAITS]
    assert decodes
    sums = dict.fromkeys(WAITS, 0)
    for d in decodes:
        inside = sorted((w for w in waits if w.thread == d.thread
                         and d.t0_ns <= w.t0_ns and w.t1_ns <= d.t1_ns),
                        key=lambda w: (w.t0_ns, -w.t1_ns))
        top = []
        for w in inside:      # drop a wait that lies inside the one before
            if top and w.t1_ns <= top[-1].t1_ns:
                continue
            assert not top or top[-1].t1_ns <= w.t0_ns
            top.append(w)
        assert any(w.attrs.get("what") == "tokens" for w in top)
        assert sum(w.ns for w in top) <= d.ns
        for w in top:
            sums[w.name] += w.ns
    run = SimpleNamespace(w0_ns=min(s.t0_ns for s in spans),
                          last_ns=max(s.t1_ns for s in spans))
    n, total, weights, device = programspans.decode_parts(run)
    assert (n, total) == (len(decodes), sum(d.ns for d in decodes))
    assert (weights, device) == (sums["wait.weights"], sums["wait.device"])
    parts = [spec.metric_reader(m)(run) for m in (
        "decode_dispatch_ms", "decode_weight_wait_ms",
        "decode_device_wait_ms")]
    assert sum(parts) == pytest.approx(total / n / 1e6, rel=1e-9)


def test_profiler_ops_fall_inside_their_pass(model):
    """Kineto stamps its CPU ops on the spans' clock: every pass's greedy
    pick (one ``aten::argmax``) lies inside that pass's span."""
    _, spans, prof = _serve(model, 0.5, traced=True)
    passes = sorted((s for s in spans
                     if s.name in ("serve.admit", "serve.decode")),
                    key=lambda s: s.t0_ns)
    picks = sorted((e for e in prof.profiler.kineto_results.events()
                    if e.name() == "aten::argmax"),
                   key=lambda e: e.start_ns())
    assert len(picks) == len(passes)
    for p, e in zip(passes, picks):
        assert p.t0_ns <= e.start_ns() <= e.end_ns() <= p.t1_ns


def test_buffer_is_bounded(model, monkeypatch):
    monkeypatch.setattr(trace, "MAX_SPANS", 10)
    _, spans, _ = _serve(model, 0.5, traced=True)
    assert len(spans) == 10 and trace.dropped() > 0
    trace.clear()
    assert trace.spans() == [] and trace.dropped() == 0
