"""CUDA graphs of the fused decode pass (``PipelinedExecutor.decode_fused``,
``core/cudagraph.py``).

On the CPU, through a stand-in capture (``Stub``) that keeps the pass's
Python and runs it again on each replay, so the engage decision, the keys
and their invalidation run here: a resident plan, dense and hybrid,
captures once per decode tier and replays after, with the tokens of an
eager serve; a streamed plan, a paged cache, speculation, per-slot decode
and an MoE model never capture; a rebind recaptures once; an injected
allocation failure still fires before the replay and the tokens stay an
undisturbed run's; and the host counts after replayed steps equal an eager
serve's.

Also on the CPU: the recording (``cudagraph._Recording``) over stand-in
graphs: each K1 launch (``cudagraph.eager``) ends one graph and begins
the next and runs again on every replay, between them; and the
``ExecStats`` counts of one pass added on a replay.

On a card (skipped without one) the checks of ``chip_smoke.py``'s phase
20: ``decode_graph_check`` on a resident qwen3-14b-shaped plan
(published widths, 2 layers) and a resident Nemotron-H-shaped hybrid
(``M*-``), graphed passes ``torch.equal`` to eager ones at the card's
own tier pick and then at four tiers, caches equal, one recording per
tier, one more after a rebind, K1 launched as often graphed as eager;
and ``concurrent_cublas_check``. Run there with ``python -m pytest
--noconftest -q tests/test_torch_decode_graph.py`` (the shared conftest
imports JAX, which these tests do not use).
"""
from dataclasses import asdict
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import Session
from repro_torch.configs import get_smoke_config
from repro_torch.core import (CLI2, ExecStats, FaultPlan, FaultSpec,
                              InferenceSetting, build_graph, cudagraph,
                              run_install, total_weight_bytes, trace)
from repro_torch.core.serving import Request
from repro_torch.kernels import streamed_matmul as smm

ROOT = Path(__file__).resolve().parents[1]
MAX_BATCH, MAX_SEQ = 4, 160
# graph counters: the only host counts a graphed serve keeps apart
GRAPH_COUNTS = ("decode_graph_captures", "decode_graph_replays")


class Stub:
    """A capture that keeps the pass's Python: each replay runs it again,
    eagerly, on the CPU."""

    def __init__(self):
        self.captures = 0
        self.replays = 0

    def supports(self, device):
        return True

    def warm(self, device, fn):
        return fn()

    def capture(self, device, fn):
        self.captures += 1

        def replay():
            self.replays += 1
            return fn()
        return replay


@pytest.fixture(scope="module")
def db():
    return run_install(CLI2, quick=True)


def _model(name):
    """(config, host weights or None for the port's own init)."""
    if name == "hybrid":
        import sys
        sys.path.insert(0, str(ROOT))
        from portbench import spec
        from portbench.test_portbench_nemotron_h import TINY_NEMOTRON_H
        from portbench.weights import draw_weights
        c = dict(TINY_NEMOTRON_H, torch_dtype="float32")
        arch = spec.architecture(c)
        s = arch.shapes(c, "tiny-nemotron-h")
        return arch.port_config(c, s), draw_weights(arch.leaves(s), 5, "cpu")
    return get_smoke_config({"dense": "qwen2-0.5b", "moe": "qwen30b-a3b"}[
        name]).replace(dtype="float32"), None


def _open(db, name, frac, capture=None, **kw):
    cfg, params = _model(name)
    total = total_weight_bytes(build_graph(cfg, expert_granular=cfg.moe
                                           is not None))
    sess = Session.open(cfg, CLI2, int(total * frac),
                        InferenceSetting(batch=MAX_BATCH, context=MAX_SEQ),
                        db=db, params=params, max_seq=MAX_SEQ, device="cpu",
                        **kw)
    if capture is not None:
        sess.executor.graph_capture = capture
    return sess


def _requests(vocab, new=(24, 18, 12, 6)):
    """Four requests finishing one after another, so the fused passes run
    at 4, 3, 2 and 1 active slots (both decode tiers of ``TIERS``)."""
    rng = np.random.RandomState(1)
    return [Request(rid=i, prompt=rng.randint(0, vocab, size=5 + 4 * i)
                    .astype(np.int32), max_new_tokens=n)
            for i, n in enumerate(new)]


def _serve(sess, fused=True, new=(24, 18, 12, 6)):
    reqs = _requests(sess.cfg.vocab, new)
    sess.batcher(max_batch=MAX_BATCH, fused=fused).serve(reqs)
    return [r.generated for r in reqs]


def _host_counts(stats):
    out = asdict(stats)
    for k in GRAPH_COUNTS + ("rebind_s",):
        out.pop(k)
    return out


@pytest.mark.parametrize("name", ["dense", "hybrid"])
def test_resident_plan_captures_once_per_tier(db, name):
    eager = _serve(_open(db, name, 2.0))
    stub = Stub()
    sess = _open(db, name, 2.0, capture=stub)
    trace.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        tokens = _serve(sess)
    passes = [(s.attrs["tier"], s.attrs["graphed"]) for s in trace.spans()
              if s.name == "serve.decode"]
    trace.clear()
    st = sess.executor.stats
    tiers = sorted({t for t, _ in passes})
    assert tokens == eager
    assert len(passes) >= 20 and len(tiers) == 2
    assert st.decode_graph_captures == stub.captures == len(tiers)
    assert st.decode_graph_replays == stub.replays \
        == len(passes) - len(tiers)
    # each tier's first pass runs eagerly and is captured; every later
    # one replays
    for t in tiers:
        flags = [g for tier, g in passes if tier == t]
        assert flags == [False] + [True] * (len(flags) - 1)


@pytest.mark.parametrize("case", ["streamed", "paged", "spec", "per_slot",
                                  "moe"])
def test_other_passes_never_capture(db, case):
    stub = Stub()
    kw = {"streamed": dict(frac=0.5), "paged": dict(kv_layout="paged"),
          "per_slot": {}, "moe": dict(name="moe"),
          "spec": dict(draft_cfg=_model("dense")[0], spec_k=2)}[case]
    sess = _open(db, kw.pop("name", "dense"), kw.pop("frac", 2.0), stub,
                 **kw)
    if case == "spec":
        assert sess.spec_active
    tokens = _serve(sess, fused=case != "per_slot")
    st = sess.executor.stats
    assert all(len(t) == n for t, n in zip(tokens, (24, 18, 12, 6)))
    assert st.decode_passes > 0 or st.spec_verify_passes > 0
    if case == "streamed":
        assert st.streamed_bytes + st.at_use_bytes > 0
    assert stub.captures == st.decode_graph_captures == 0
    assert stub.replays == st.decode_graph_replays == 0


def test_rebind_recaptures_once(db):
    """Four requests of one length: every fused pass runs at 4 active
    slots, one tier. A rebind between passes drops its graph; the next
    pass captures it again, once."""
    new = (12, 12, 12, 12)
    eager = _serve(_open(db, "dense", 2.0), new=new)
    stub = Stub()
    sess = _open(db, "dense", 2.0, capture=stub)
    reqs = _requests(sess.cfg.vocab, new)
    b = sess.batcher(max_batch=MAX_BATCH)
    b.submit(reqs)
    for _ in range(5):
        b.step()
    st = sess.executor.stats
    assert (st.decode_graph_captures, st.decode_graph_replays) == (1, 4)
    sess.update_budget(sess.budget_bytes)
    assert st.rebinds == 1
    b.serve([])
    assert [r.generated for r in reqs] == eager
    assert st.decode_graph_captures == stub.captures == 2
    assert st.decode_graph_replays == st.decode_passes - 2


def test_alloc_fault_fires_before_the_replay(db):
    """``alloc.device`` fails the seventh fused pass, a replay: the pass
    aborts before its inputs reach the graph, the session walks a rung
    (a re-plan, whose rebind drops the graphs) and re-runs it, and the
    tokens are an undisturbed serve's."""
    eager = _serve(_open(db, "dense", 2.0))
    stub = Stub()
    sess = _open(db, "dense", 2.0, capture=stub, faults=FaultPlan(
        [FaultSpec("alloc.device", "oom", after=6, key="decode")]))
    assert _serve(sess) == eager
    st = sess.executor.stats
    assert st.fault_alloc_failures == 1 and sess.degradation_level > 0
    assert st.decode_graph_captures == stub.captures > 2
    assert st.decode_graph_replays == stub.replays


@pytest.mark.parametrize("name", ["dense", "hybrid"])
def test_replayed_counts_equal_eager(db, name):
    a = _open(db, name, 2.0)
    b = _open(db, name, 2.0, capture=Stub())
    assert _serve(a) == _serve(b)
    assert b.executor.stats.decode_graph_replays > 20
    assert a.executor.stats.decode_graph_captures == 0
    assert _host_counts(a.executor.stats) == _host_counts(b.executor.stats)


def test_counts_replay_adds_one_pass():
    """``mark`` / ``since`` take what one pass added to ``ExecStats``;
    ``apply`` adds it again; ``counts_discarded`` leaves nothing behind.
    The kernels' launch counters are not theirs: the wrappers count every
    launch, a replay's too."""
    st = ExecStats()
    st.tiers_used.append(1)
    at = cudagraph.mark(st)
    launches = smm.streamed_matmul.launches
    st.tiers_used.append(4)
    st.engine_calls["gpu"] += 3
    st.decode_passes += 1
    st.pass_streamed_bytes.append(0)
    grown = cudagraph.since(st, at)
    cudagraph.apply(st, grown)
    assert st.tiers_used == [1, 4, 4] and st.decode_passes == 2
    assert st.engine_calls == {"gpu": 6, "cpu": 0}
    assert st.pass_streamed_bytes == [0, 0]
    assert smm.streamed_matmul.launches == launches

    class Owner:
        stats = st
    with cudagraph.counts_discarded(Owner):
        Owner.stats.decode_passes += 5
    assert Owner.stats is st and st.decode_passes == 2
    st.degraded_sync = True
    with pytest.raises(ValueError):
        cudagraph.since(st, cudagraph.mark(ExecStats()))


class FakeGraph:
    """Records the ``op`` calls made between its ``capture_begin`` and
    ``capture_end``, warns as PyTorch does when it recorded none, and
    replays them."""
    now = None

    def __init__(self):
        self.ops = []

    def capture_begin(self, **kw):
        assert kw == {"pool": "p"} and FakeGraph.now is None
        FakeGraph.now = self

    def capture_end(self):
        FakeGraph.now = None
        if not self.ops:
            import warnings
            warnings.warn("The CUDA Graph is empty. This usually means ...")

    def replay(self):
        for fn in self.ops:
            fn()


def test_recording_launches_between_graphs():
    """A pass recorded through ``cudagraph.eager``: each launch ends one
    graph and begins the next; the recording launches nothing, and every
    replay launches it between the two, its output copied into the tensor
    the recording handed on; two launches in a row leave no empty graph
    behind; another thread's launch is not split."""
    log = []

    def op(name):
        def run():
            log.append(name)
        if FakeGraph.now is not None:
            FakeGraph.now.ops.append(run)
        else:
            run()

    def k1(x):
        log.append(f"k1({int(x)})")
        return x * 2

    x = torch.tensor(3.0)
    results = []

    def launch(x):
        return cudagraph.eager(k1, (x,), x.shape, x.dtype)

    def pass_():
        op("attn")
        a = launch(x)
        b = launch(x + 1)
        op("act")
        results.append((a, b))
        return a, b

    other = []
    t = None
    rec = cudagraph._Recording(FakeGraph, pool="p")
    rec.begin()
    cudagraph._local.recording = rec
    try:
        import threading
        t = threading.Thread(target=lambda: other.append(
            launch(torch.tensor(5.0))))
        t.start()
        t.join()
        a, b = pass_()
    finally:
        cudagraph._local.recording = None
        rec.end()
    # recording runs neither the ops nor the launches
    assert log == ["k1(5)"] and other[0].item() == 10
    assert len(rec.steps) == 2 + 2     # attn, k1, k1, act: no empty graph
    log.clear()
    for step in rec.steps:
        step()
    assert log == ["attn", "k1(3)", "k1(4)", "act"]
    assert (a.item(), b.item()) == (6.0, 8.0)
    # outside a recording a launch is a plain call
    assert launch(x).item() == 6.0


# ------------------------------------------------------------ on a card
# the checks live in chip_smoke.py (phase 20), which these tests run


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import sys
    sys.path.insert(0, str(ROOT))
    return torch.device("cuda")


@pytest.mark.card
@pytest.mark.parametrize("model", ["qwen3-14b", "nemotron-h"])
def test_graphed_equals_eager_on_card(card, model):
    import chip_smoke
    out = chip_smoke.decode_graph_check(model, card)
    assert out["captures"] == len(out["own_tiers"]) + len(out["tiers"])
    assert out["k1_per_pass"] > 0


@pytest.mark.card
def test_other_threads_matmuls_across_recordings_on_card(card):
    import chip_smoke
    assert chip_smoke.concurrent_cublas_check(card) > 0
