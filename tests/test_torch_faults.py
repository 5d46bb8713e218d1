"""The port's fault injection and degradation ladder against the JAX
package, on the CPU (smoke yi-9b and qwen30b-a3b, monolithic at the
executor and expert-granular in sessions; f32 weights bridged from the
reference's; numpy-seeded prompts; the same ``FaultSpec``s built in each
package).

Held equal to the reference under every plan: the tokens, the
streamed-bytes ledger, the fault counters (retries, failures, worker
crashes, demand timeouts, sync fallbacks, allocation failures, the
watchdog), the ``degrade_log`` rungs and levels, ``Session.degradation()``
and ``FaultPlan.fired`` as (point, key, mode, hit) on the static and
expert points, ``at`` dropped. On paged runs a layer's evicted blocks are
one demand entry in the port and one per block in the reference, so there
the demand points' hits are left out and the tokens, the ledger and the
pool's consistency are held instead.

Also the two repairs: a static prefetch worker that dies wakes every
pending ``acquire`` with ``WorkerLost`` and ``finish`` returns (each run
under a wall-clock guard, so a hang fails the test); a ``PagePoolFull``
walks the ladder as in the reference. And an error of CUDA itself (a
stand-in here) is never retried or recovered from.
"""
import gc
import threading

import jax
import numpy as np
import pytest
import torch

import repro
from repro.configs import get_smoke_config as jax_smoke
from repro.core import CLI2 as JCLI2
from repro.core import InferenceSetting as JSetting
from repro.core import TimingEstimator as JEstimator
from repro.core import build_schedule as jax_schedule
from repro.core import faults as jfaults
from repro.core import run_install as jax_install
from repro.core.executor import PipelinedExecutor as JExecutor
from repro.core.kvpaged import PagePoolFull as JPagePoolFull
from repro.core.serving import Request as JRequest
from repro.models import build_model as jax_build
from repro.models.common import greedy_token as jax_greedy
from repro_torch import Session
from repro_torch.configs import get_smoke_config as torch_smoke
from repro_torch.core import (CLI2, InferenceSetting, Placement,
                              TimingEstimator, build_graph, build_schedule,
                              run_install)
from repro_torch.core import faults as tfaults
from repro_torch.core.executor import PipelinedExecutor
from repro_torch.core.faults import (DEGRADATION_RUNGS, AllocationFault,
                                     DemandTimeout, FaultPlan, FaultSpec,
                                     RecoveryPolicy, TransferFault,
                                     WorkerLost)
from repro_torch.core.kvpaged import PagePoolFull
from repro_torch.core.prefetch import PrefetchEngine, is_device_error
from repro_torch.core.serving import ContinuousBatcher, Request
from repro_torch.models.api import params_from_numpy
from repro_torch.models.common import greedy_token

torch.set_num_threads(1)

SETTING = dict(batch=2, context=64)
MAX_SEQ = 64
ARCHES = ("yi-9b", "qwen30b-a3b")
DRAFT = "qwen2-0.5b"
# a hang fails the test instead of stalling the run
WALL_S = 60.0
# stands in for an error raised by CUDA itself
CUDA_ERROR = "CUDA error: an illegal memory access was encountered"


def fast(pkg):
    """Backoff without wall-clock cost, in either package."""
    return pkg.RecoveryPolicy(sleep=lambda s: None, backoff_base_s=0.0)


def plans(specs):
    """The same specs as a FaultPlan of each package: (reference, port)."""
    if specs is None:
        return None, None
    return (jfaults.FaultPlan([dict(s) for s in specs]),
            tfaults.FaultPlan([dict(s) for s in specs]))


def fired(plan, points=None):
    return [(f["point"], f["key"], f["mode"], f["hit"]) for f in plan.fired
            if points is None or f["point"] in points]


def within(fn, seconds=WALL_S):
    """``fn()`` on a thread of its own, failing if it has not returned
    after ``seconds``."""
    out = {}

    def run():
        try:
            out["value"] = fn()
        except BaseException as e:
            out["error"] = e

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(seconds)
    assert not t.is_alive(), f"still running after {seconds} s: a hang"
    if "error" in out:
        raise out["error"]
    return out.get("value")


@pytest.fixture(scope="module")
def dbs():
    return jax_install(JCLI2, quick=True), run_install(CLI2, quick=True)


@pytest.fixture(scope="module")
def models():
    """(arch, seed) -> (jax cfg, port cfg, jax params, port params), f32
    so that the two packages' tokens compare exactly."""
    cache = {}

    def get(arch, seed=0):
        if (arch, seed) not in cache:
            jcfg = jax_smoke(arch).replace(dtype="float32")
            tcfg = torch_smoke(arch).replace(dtype="float32")
            jp = jax_build(jcfg).init(jax.random.PRNGKey(seed))
            cache[(arch, seed)] = (jcfg, tcfg, jp, params_from_numpy(
                jax.tree.map(np.asarray, jp)))
        return cache[(arch, seed)]

    return get


def total_bytes(cfg, eg=False):
    return sum(s.weight_bytes for s in build_graph(cfg, wdtype=2,
                                                   expert_granular=eg))


# ============================================================ catalog
def test_catalog_and_exceptions_are_the_reference_s():
    assert tfaults.POINTS == jfaults.POINTS
    assert tfaults.MODES == jfaults.MODES
    assert tfaults.DEGRADATION_RUNGS == jfaults.DEGRADATION_RUNGS
    for name in ("TransferFault", "WorkerCrash", "AllocationFault",
                 "DemandTimeout"):
        assert issubclass(getattr(tfaults, name), tfaults.FaultError)
    assert not issubclass(WorkerLost, tfaults.FaultError)
    assert tfaults._MODE_EXC.keys() == jfaults._MODE_EXC.keys()


def test_fault_plan_is_deterministic_and_equal_to_the_reference():
    specs = [dict(point="prefetch.copy", mode="fail", after=2, count=2),
             dict(point="demand.timeout", mode="timeout", key="exp")]
    logs = []
    for pkg in (jfaults, tfaults, tfaults):
        plan = pkg.FaultPlan([pkg.FaultSpec(**s) for s in specs], seed=7,
                             clock=lambda: 0.0)
        for i in range(6):
            try:
                plan.check("prefetch.copy", key=f"s{i}")
            except pkg.TransferFault:
                pass
        with pytest.raises(pkg.DemandTimeout):
            plan.check("demand.timeout", key="expert3")
        plan.check("demand.timeout", key="other")   # key filter: no match
        logs.append((fired(plan), plan.counters()))
    assert logs[0] == logs[1] == logs[2]
    assert logs[1][0] == [("prefetch.copy", "s2", "fail", 2),
                          ("prefetch.copy", "s3", "fail", 3),
                          ("demand.timeout", "expert3", "timeout", 0)]
    assert logs[1][1]["fired"] == {"prefetch.copy:fail": 2,
                                   "demand.timeout:timeout": 1}


@pytest.mark.parametrize("kw", [
    dict(point="prefetch.cpoy"), dict(point="prefetch.copy", mode="explode"),
    dict(point="prefetch.copy", mode="delay"),
    dict(point="prefetch.copy", count=0)])
def test_fault_spec_validates_catalog(kw):
    with pytest.raises(ValueError):
        FaultSpec(**kw)
    with pytest.raises(ValueError):
        jfaults.FaultSpec(**kw)


def test_fault_delay_and_recovery_policy():
    slept = []
    FaultPlan([FaultSpec("prefetch.copy", "delay", delay_s=0.25)],
              sleep=slept.append).check("prefetch.copy")
    assert slept == [0.25]
    pol = RecoveryPolicy(backoff_base_s=0.01, backoff_mult=2.0)
    assert pol.backoff_s(2) == pytest.approx(0.04)
    assert pol.retryable(TransferFault("x"))
    assert not pol.retryable(AllocationFault("x"))
    assert not pol.retryable(KeyboardInterrupt())


# ============================================================ executor
@pytest.fixture(scope="module")
def arches(models, dbs):
    """arch -> both packages' schedules at 0.2x of the weight bytes, the
    prompts and the clean tokens (the port's sync run, equal to the
    reference's)."""
    out = {}
    rng = np.random.RandomState(7)
    for arch in ARCHES:
        jcfg, tcfg, jp, tp = models(arch)
        budget = int(total_bytes(tcfg) * 0.2) + 1
        jsched = jax_schedule(budget, repro.core.build_graph(jcfg, wdtype=2),
                              JEstimator(dbs[0], JCLI2), JSetting(**SETTING))
        tsched = build_schedule(budget, build_graph(tcfg, wdtype=2),
                                TimingEstimator(dbs[1], CLI2),
                                InferenceSetting(**SETTING))
        a = dict(jcfg=jcfg, tcfg=tcfg, jp=jp, tp=tp, jsched=jsched,
                 tsched=tsched,
                 tokens=rng.randint(0, tcfg.vocab, (2, 12)).astype(np.int32))
        ex, gen = run_port(a, None, overlap=False)
        a.update(ref_gen=gen, ref_streamed=ex.stats.streamed_bytes)
        out[arch] = a
    return out


def run_port(a, plan, overlap=True, recovery=None):
    ex = PipelinedExecutor(a["tcfg"], a["tp"], a["tsched"], max_seq=MAX_SEQ,
                           overlap=overlap, device="cpu", faults=plan,
                           recovery=recovery or fast(tfaults))
    last, kv, pos = ex.prefill(torch.as_tensor(a["tokens"]))
    gen, _ = ex.decode(greedy_token(last), kv, pos, steps=5)
    return ex, np.asarray(gen)


def run_ref(a, plan):
    ex = JExecutor(a["jcfg"], a["jp"], a["jsched"], max_seq=MAX_SEQ,
                   faults=plan, recovery=fast(jfaults))
    last, kv, pos = ex.prefill(jax.numpy.asarray(a["tokens"]))
    gen, _ = ex.decode(jax_greedy(last), kv, pos, steps=5)
    return ex, np.asarray(gen)


EXEC_COUNTERS = ("streamed_bytes", "fault_copy_retries",
                 "fault_copy_failures", "fault_worker_crashes",
                 "fault_demand_timeouts", "fault_sync_fallbacks",
                 "fault_alloc_failures", "degraded_sync")


def faulted_pair(a, specs):
    """The same plan through both packages' executors: the port's tokens,
    ledger, fault counters and fired log equal the reference's, and the
    tokens equal the undisturbed run's. Returns the port's executor and
    plan."""
    jplan, tplan = plans(specs)
    jex, jgen = run_ref(a, jplan)
    tex, tgen = run_port(a, tplan)
    assert np.array_equal(tgen, jgen)
    assert np.array_equal(tgen, a["ref_gen"])
    for key in EXEC_COUNTERS:
        assert getattr(tex.stats, key) == getattr(jex.stats, key), key
    assert tex.stats.streamed_bytes == a["ref_streamed"]
    assert fired(tplan) == fired(jplan)
    assert tplan.counters() == jplan.counters()
    return tex, tplan


@pytest.mark.parametrize("arch", ARCHES)
def test_empty_plan_is_bit_identical_to_no_plan(arch, arches):
    a = arches[arch]
    ex0, gen0 = run_port(a, None)
    plan = FaultPlan([])
    ex, gen = run_port(a, plan)
    assert np.array_equal(gen, gen0) and np.array_equal(gen, a["ref_gen"])
    assert ex.stats.streamed_bytes == ex0.stats.streamed_bytes \
        == a["ref_streamed"]
    assert ex.stats.tiers_used == ex0.stats.tiers_used
    assert plan.counters()["fired_total"] == 0
    assert all(not getattr(ex.stats, k) for k in EXEC_COUNTERS[1:])


def test_no_faults_session_plan_signature_unchanged(models, dbs):
    _, tcfg, _, tp = models("yi-9b")
    budget = int(total_bytes(tcfg) * 0.3) + 1
    s0, s1 = (Session.open(tcfg, CLI2, budget, InferenceSetting(**SETTING),
                           db=dbs[1], params=tp, max_seq=MAX_SEQ,
                           device="cpu", **kw)
              for kw in ({}, dict(faults=FaultPlan([]),
                                  recovery=fast(tfaults))))
    d = s0.schedule.diff(s1.schedule)
    assert not d.to_pin and not d.to_evict
    assert not d.tier_plan_changes and not d.stream_bytes_changes
    assert s0.schedule.pinned_bytes == s1.schedule.pinned_bytes
    with pytest.raises(TypeError, match="FaultPlan"):
        Session.open(tcfg, CLI2, budget, db=dbs[1], params=tp,
                     device="cpu", faults=[FaultSpec("prefetch.copy")])


@pytest.mark.parametrize("arch", ARCHES)
def test_copy_fail_retried_ledger_exact(arch, arches):
    ex, _ = faulted_pair(arches[arch], [dict(point="prefetch.copy",
                                             mode="fail", count=2)])
    assert ex.stats.fault_copy_retries == 2
    assert ex.stats.fault_copy_failures == ex.stats.fault_sync_fallbacks == 0


@pytest.mark.parametrize("arch", ARCHES)
def test_copy_fail_exhausted_falls_back_to_sync_fetch(arch, arches):
    ex, _ = faulted_pair(arches[arch], [dict(point="prefetch.copy",
                                             mode="fail", count=20)])
    assert ex.stats.fault_copy_failures >= 1
    assert ex.stats.fault_sync_fallbacks == ex.stats.fault_copy_failures


def test_copy_delay_only_slows(arches):
    _, plan = faulted_pair(arches["yi-9b"], [dict(
        point="prefetch.copy", mode="delay", delay_s=0.01, count=3)])
    assert plan.counters()["fired"]["prefetch.copy:delay"] == 3


@pytest.mark.parametrize("arch", ARCHES)
def test_worker_crash_degrades_to_sync_mid_serve(arch, arches):
    ex, _ = faulted_pair(arches[arch], [dict(point="prefetch.worker",
                                             mode="crash", after=1)])
    assert ex.stats.fault_worker_crashes == 1
    assert ex.stats.fault_sync_fallbacks >= 1
    assert ex.stats.degraded_sync


# ============================================================ repairs
def _placements(n):
    cfg = torch_smoke("yi-9b")
    subs = [s for s in build_graph(cfg, wdtype=2) if s.weight_bytes][:n]
    return [Placement(s, "vram", "gpu", streamed=True) for s in subs]


@pytest.mark.parametrize("how", ["fault point", "slot wait"])
def test_static_worker_death_wakes_every_pending_acquire(how):
    """The repair: the static worker dies at its second item (the
    ``prefetch.worker`` point's crash, or an error that escapes the
    staging of an item); each pending ``acquire`` raises ``WorkerLost``
    and ``finish`` returns, all under the wall-clock guard."""
    order = _placements(4)
    calls = []

    def fetch(sub):
        calls.append(sub.name)
        return [{"w": torch.ones(4)}]

    eng = PrefetchEngine(fetch, torch.device("cpu"), recovery=fast(tfaults),
                         faults=FaultPlan([FaultSpec(
                             "prefetch.worker", "crash", after=1)])
                         if how == "fault point" else None)
    if how == "slot wait":
        # a failure outside _stage_one's guard: the slot wait itself
        taken = []
        real = eng._take_slot

        def take():
            taken.append(1)
            if len(taken) == 2:
                raise RuntimeError("slot wait failed")
            real()

        eng._take_slot = take
    eng.start(order, avail_bytes=None)
    within(lambda: eng.acquire(order[0].sub.name))
    eng.release(order[0].sub.name)
    for pl in order[1:]:
        with pytest.raises(WorkerLost):
            within(lambda: eng.acquire(pl.sub.name))
        eng.discard(pl.sub.name)
    within(eng.finish)
    assert eng.stats.worker_crashes == 1
    assert isinstance(eng.worker_error, WorkerLost)
    assert not eng.active and calls == [order[0].sub.name]


def _frames(*names):
    import types
    import warnings
    with warnings.catch_warnings():   # a deprecated torch alias on the heap
        warnings.simplefilter("ignore")
        return [f for f in gc.get_objects() if isinstance(f, types.FrameType)
                and f.f_code.co_name in names]


@pytest.mark.parametrize("arch,frac,spec", [
    ("yi-9b", 0.2, dict(point="prefetch.worker", mode="crash", after=1)),
    ("yi-9b", 0.2, dict(point="prefetch.copy", mode="fail", count=20)),
    ("qwen30b-a3b", 0.3, dict(point="demand.copy", mode="fail", count=20)),
    ("qwen30b-a3b", 0.3, dict(point="demand.worker", mode="crash")),
], ids=["static-crash", "static-copy", "demand-copy", "demand-crash"])
def test_handled_faults_keep_no_frame_alive(arch, frac, spec, models, dbs):
    """A handled fault drops its traceback: an injected fault's traceback
    holds ``FaultPlan.check``'s frame, whose local holds the fault, and a
    failed entry's error is held by the entry, a local of ``acquire``'s
    frame. The cycles kept the frames of the pass alive, with their
    callers', until the garbage collector ran: on the card a crashed
    pass's recovered shards (1,044 MB against a 504 MB bound) and each
    retried MoE layer's dispatch buffers (64 MiB a layer). Checked with
    the collector off: no MoE layer frame outlives its layer, no pass
    frame the serve."""
    js, ts = open_pair(models, dbs, arch, frac, [spec])
    ex = ts.executor
    layers, run = [], ex._moe_granular

    def spy(*a, **kw):
        layers.append(len(_frames("_moe_granular")))
        return run(*a, **kw)

    ex._moe_granular = spy
    gc.collect()
    gc.disable()
    try:
        treqs, err = serve(ts, Request)
        # the consumer's frames (a dead static worker's cause keeps its
        # own thread's frames, which hold no tensor, for the diagnosis)
        left = _frames("_moe_granular", "_layer_loop", "_weights_for",
                       "acquire", "_copy_with_retries")
    finally:
        gc.enable()
    assert err is None and ex.stats.fault_sync_fallbacks >= 1
    assert not left and (not layers or max(layers) == 0)
    jreqs, _ = serve(js, JRequest)
    assert [r.generated for r in treqs] == [r.generated for r in jreqs]


def test_device_errors_are_never_recovered(arches):
    """An error of CUDA itself (a stand-in) is not retried, not counted
    and not turned into a sync fetch: it propagates; a host-side error of
    the same copy is retried."""
    cuda_err = RuntimeError(CUDA_ERROR)
    assert is_device_error(cuda_err)
    lost = WorkerLost("static prefetch worker died")
    lost.__cause__ = cuda_err
    assert is_device_error(lost)
    crash = WorkerLost("demand prefetch worker died")
    crash.__cause__ = tfaults.WorkerCrash("injected")
    assert not is_device_error(crash)
    assert not is_device_error(RuntimeError("host read failed"))
    assert not is_device_error(TransferFault(CUDA_ERROR))

    a = arches["yi-9b"]
    for err, recovered in ((cuda_err, False),
                           (RuntimeError("host read failed"), True)):
        ex = PipelinedExecutor(a["tcfg"], a["tp"], a["tsched"],
                               max_seq=MAX_SEQ, device="cpu",
                               recovery=fast(tfaults))
        real, first = ex._host_groups, []

        def host_groups(sub, real=real, first=first, err=err):
            if not first and sub.kind in ("attn", "ffn"):
                first.append(sub.name)
                raise err
            return real(sub)

        ex.prefetch._fetch_host = host_groups
        tokens = torch.as_tensor(a["tokens"])
        if recovered:
            last, kv, pos = ex.prefill(tokens)
            gen, _ = ex.decode(greedy_token(last), kv, pos, steps=5)
            assert np.array_equal(gen, a["ref_gen"])
            assert ex.stats.fault_copy_retries == 1
        else:
            with pytest.raises(RuntimeError, match="CUDA error"):
                within(lambda: ex.prefill(tokens))
            ex._sync_stats()
            assert ex.stats.fault_copy_retries == 0
            assert ex.stats.fault_copy_failures == 0
        assert ex.stats.fault_sync_fallbacks == 0


# ============================================================ sessions
def open_pair(models, dbs, arch, frac, specs=None, draft=False, **kw):
    """The reference's and the port's sessions over the same weights,
    budget and fault specs."""
    jcfg, tcfg, jp, tp = models(arch)
    eg = kw.get("expert_granular", tcfg.moe is not None)
    budget = int(total_bytes(tcfg, eg) * frac) + 1
    jplan, tplan = plans(specs)
    jkw, tkw = dict(kw), dict(kw)
    if draft:
        dj, dt, djp, dtp = models(DRAFT, seed=1)
        jkw.update(draft_cfg=dj, draft_params=djp)
        tkw.update(draft_cfg=dt, draft_params=dtp)
    js = repro.Session.open(jcfg, JCLI2, budget, JSetting(**SETTING),
                            db=dbs[0], params=jp, max_seq=MAX_SEQ,
                            faults=jplan, recovery=fast(jfaults), **jkw)
    ts = Session.open(tcfg, CLI2, budget, InferenceSetting(**SETTING),
                      db=dbs[1], params=tp, max_seq=MAX_SEQ, device="cpu",
                      faults=tplan, recovery=fast(tfaults), **tkw)
    return js, ts


def wave(cls, vocab, n=3, max_new=5):
    rng = np.random.RandomState(0)
    return [cls(rid=i, prompt=rng.randint(0, vocab, size=6 + 2 * i)
                .astype(np.int32), max_new_tokens=max_new)
            for i in range(n)]


def serve(sess, cls, n=3, max_new=5):
    """Serve the wave; returns (requests, the exception that ended the
    serve or None)."""
    reqs = wave(cls, sess.cfg.vocab, n, max_new)
    try:
        within(lambda: sess.serve(reqs, max_batch=2))
    except Exception as e:
        return reqs, e
    return reqs, None


def degradation(sess, paged=False):
    """``Session.degradation()`` with each ``degrade_log`` reason cut to
    its exception's message head; on paged runs without the demand
    points' hit counts (their entries differ in size)."""
    d = sess.degradation()
    if paged and "injected" in d:
        d["injected"]["hits"] = {k: v for k, v in d["injected"]["hits"]
                                 .items() if not k.startswith("demand.")}
    return d


def same_course(js, ts, jreqs, treqs, paged=False):
    assert [list(r.generated) for r in treqs] == \
        [list(r.generated) for r in jreqs]
    assert [r.error for r in treqs] == [r.error for r in jreqs]
    assert degradation(ts, paged) == degradation(js, paged)
    tst, jst = ts.stats(), js.stats()
    assert tst["executor"]["streamed_bytes"] == \
        jst["executor"]["streamed_bytes"]
    for key in ("failed", "degradations", "completed", "tiers_used"):
        assert tst["serving"][key] == jst["serving"][key], key
    if ts.faults is not None:
        points = None if not paged else \
            set(tfaults.POINTS) - {"demand.copy", "demand.timeout"}
        assert fired(ts.faults, points) == fired(js.faults, points)


@pytest.fixture(scope="module")
def moe_clean(models, dbs):
    js, ts = open_pair(models, dbs, "qwen30b-a3b", 0.3)
    (jreqs, _), (treqs, _) = serve(js, JRequest), serve(ts, Request)
    same_course(js, ts, jreqs, treqs)
    assert ts.executor.stats.demanded_expert_bytes > 0
    return [list(r.generated) for r in treqs], \
        ts.executor.stats.streamed_bytes


@pytest.mark.parametrize("spec", [
    dict(point="demand.timeout", mode="timeout", count=1),
    dict(point="demand.copy", mode="fail", count=20),
    dict(point="demand.worker", mode="crash", count=1),
], ids=["timeout", "copy", "worker"])
def test_demand_fault_never_deadlocks_moe_serve(spec, models, dbs,
                                                moe_clean):
    ref, ref_streamed = moe_clean
    js, ts = open_pair(models, dbs, "qwen30b-a3b", 0.3, [spec])
    (jreqs, je), (treqs, te) = serve(js, JRequest), serve(ts, Request)
    assert je is None and te is None
    same_course(js, ts, jreqs, treqs)
    assert [list(r.generated) for r in treqs] == ref
    ex = ts.executor.stats
    assert ex.streamed_bytes == ref_streamed
    assert ex.fault_sync_fallbacks >= 1
    if spec["point"] == "demand.timeout":
        assert ex.fault_demand_timeouts == 1
        assert ts.executor.prefetch.stats.abandoned == 1
    if spec["point"] == "demand.worker":
        assert ex.fault_worker_crashes == 1 and ex.degraded_sync
    assert ts.degradation()["injected"]["fired_total"] >= 1


# ============================================================ ladder
def test_degrade_walks_rungs_and_exhausts(models, dbs):
    js, ts = open_pair(models, dbs, "yi-9b", 0.3)
    pinned0 = ts.schedule.pinned_bytes
    for _ in range(3):
        assert ts.degrade(reason="test") == js.degrade(reason="test")
        assert ts.schedule.pinned_bytes == js.schedule.pinned_bytes
        assert ts.tiers == js.tiers and ts.overlap == js.overlap
    assert ts.schedule.pinned_bytes < pinned0
    assert ts._emergency_reserve_bytes == ts.budget_bytes // 4
    assert [e["rung"] for e in ts.degrade_log] == ["tier_down", "sync"]
    assert ts.degradation() == js.degradation()
    assert ts.stats()["degradation"]["rung"] == "sync"


def test_degrade_moe_vetoes_cold_experts(models, dbs):
    js, ts = open_pair(models, dbs, "qwen30b-a3b", 0.3)
    lvl = ts.degrade(reason="test")
    assert lvl == js.degrade(reason="test")
    assert DEGRADATION_RUNGS[lvl] == "expert_shrink"

    def vetoed(s):
        return sorted(x.name for x in s.subs if x.kind == "moe_expert"
                      and x.meta.get("pin_veto"))

    assert vetoed(ts) and vetoed(ts) == vetoed(js)
    pinned = {p.sub.name for p in ts.schedule.pinned_placements()}
    assert not pinned & set(vetoed(ts))
    assert pinned == {p.sub.name for p in js.schedule.pinned_placements()}
    assert ts.degradation() == js.degradation()


def test_alloc_fault_degrades_spec_off_on_a_speculative_session(models,
                                                                dbs):
    """On a speculative session the first rung is ``spec_off``: the draft
    carve goes, the draft itself is dropped, and the tokens equal plain
    greedy serving's."""
    _, plain = open_pair(models, dbs, "yi-9b", 2.0)
    preqs, _ = serve(plain, Request)
    js, ts = open_pair(models, dbs, "yi-9b", 2.0,
                       [dict(point="alloc.device", mode="oom", after=3)],
                       draft=True, spec_k=2)
    assert ts.spec_active and ts.draft_carve_bytes > 0
    (jreqs, je), (treqs, te) = serve(js, JRequest), serve(ts, Request)
    assert je is None and te is None
    same_course(js, ts, jreqs, treqs)
    assert [list(r.generated) for r in treqs] == \
        [list(r.generated) for r in preqs]
    assert [e["rung"] for e in ts.degrade_log] == ["spec_off"]
    assert ts.draft_carve_bytes == 0 and not ts.spec_active
    assert ts._spec_decoder is None and ts.batcher().spec is None


def test_alloc_fault_degrades_and_serve_stays_bit_identical(models, dbs):
    _, clean = open_pair(models, dbs, "yi-9b", 0.3)
    creqs, _ = serve(clean, Request)
    js, ts = open_pair(models, dbs, "yi-9b", 0.3,
                       [dict(point="alloc.device", mode="oom", after=2)])
    (jreqs, je), (treqs, te) = serve(js, JRequest), serve(ts, Request)
    assert je is None and te is None
    same_course(js, ts, jreqs, treqs)
    assert [list(r.generated) for r in treqs] == \
        [list(r.generated) for r in creqs]
    assert len(ts.batcher().degradations) == 1
    d = ts.stats()["degradation"]
    assert d["alloc_failures"] == 1 and d["rung"] == "tier_down"


def test_alloc_fault_without_session_raises(arches):
    a = arches["yi-9b"]
    ex = PipelinedExecutor(
        a["tcfg"], a["tp"], a["tsched"], max_seq=MAX_SEQ, device="cpu",
        faults=FaultPlan([FaultSpec("alloc.device", "oom")]),
        recovery=fast(tfaults))
    b = ContinuousBatcher(a["tcfg"], executor=ex, max_batch=2)
    b.submit(wave(Request, a["tcfg"].vocab, n=1))
    with pytest.raises(AllocationFault):
        b.serve([])
    assert ex.stats.fault_alloc_failures == 1


def test_alloc_host_fault_paged_recovers_and_pool_is_consistent(models,
                                                                dbs):
    _, clean = open_pair(models, dbs, "yi-9b", 0.3, kv_layout="paged")
    creqs, _ = serve(clean, Request)
    js, ts = open_pair(models, dbs, "yi-9b", 0.3,
                       [dict(point="alloc.host", mode="oom", after=1)],
                       kv_layout="paged")
    (jreqs, je), (treqs, te) = serve(js, JRequest), serve(ts, Request)
    assert je is None and te is None
    same_course(js, ts, jreqs, treqs, paged=True)
    assert [list(r.generated) for r in treqs] == \
        [list(r.generated) for r in creqs]
    b = ts.batcher()
    b.kv.alloc.check()
    assert all(sl is None for sl in b.slots)
    assert len(b.kv.alloc.blocks) == 0, "paged-KV blocks leaked"
    assert ts.degradation()["injected"]["fired"] == {"alloc.host:oom": 1}


def test_page_pool_full_walks_the_ladder_as_the_reference(models, dbs):
    """The repair: a real ``PagePoolFull`` (a pool too small for the
    wave) is an allocation failure in both packages, caught on admission
    and on each iteration: the same rungs, then the same tokens or, once
    the ladder is exhausted, the same exception."""
    js, ts = open_pair(models, dbs, "yi-9b", 0.3, kv_layout="paged",
                       kv_pool_pages=1)
    (jreqs, je), (treqs, te) = serve(js, JRequest), serve(ts, Request)
    assert type(je) is JPagePoolFull if je is not None else te is None
    assert type(te) is PagePoolFull if te is not None else je is None
    assert ts.degrade_log == js.degrade_log
    assert [e["rung"] for e in ts.degrade_log] == ["tier_down", "sync"]
    same_course(js, ts, jreqs, treqs, paged=True)
    ts.batcher().kv.alloc.check()


# ============================================================ per request
def test_request_fault_fails_one_slot_only(models, dbs):
    _, clean = open_pair(models, dbs, "yi-9b", 0.3)
    creqs, _ = serve(clean, Request)
    js, ts = open_pair(models, dbs, "yi-9b", 0.3, [dict(
        point="serving.request", mode="fail", key="1", after=1)])
    (jreqs, je), (treqs, te) = serve(js, JRequest), serve(ts, Request)
    assert je is None and te is None
    same_course(js, ts, jreqs, treqs)
    assert treqs[1].error is not None and not treqs[1].done
    for i in (0, 2):
        assert list(treqs[i].generated) == list(creqs[i].generated)
    b = ts.batcher()
    assert b.stats()["failed"] == 1 and b.stats()["completed"] == 2
    assert [r.rid for r in b.failed] == [1]
    assert all(sl is None for sl in b.slots)


def test_request_fault_emits_error_event(models, dbs):
    _, ts = open_pair(models, dbs, "yi-9b", 0.3, [dict(
        point="serving.request", mode="fail", key="0", after=1)])
    b = ts.batcher(max_batch=2)
    b.submit(wave(Request, ts.cfg.vocab, n=1))
    errs = []
    while b.has_work:
        errs += [e for e in b.step() if e.error is not None]
    assert len(errs) == 1
    assert errs[0].rid == 0 and errs[0].done and errs[0].token == -1
    assert isinstance(DemandTimeout("x"), tfaults.FaultError)
