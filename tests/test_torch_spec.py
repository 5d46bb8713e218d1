"""The port's speculative decoding against the JAX package, on the CPU
(targets: smoke yi-9b, qwen30b-a3b monolithic and expert-granular; draft:
smoke qwen2-0.5b; the JAX package's weights through the numpy param
bridge; numpy-seeded requests; the reference's schedules).

Against the reference: exactly, in f32, the served tokens and the
speculation counters (``spec_drafted``, ``spec_accepted``,
``spec_rolled_back_tokens``) with bridged target and draft weights, each
verify pass's ledger, and the planner's integers (``plan_draft_carve``
bytes, the draft schedule's pins, the carve-free plan at ``spec_k=0``);
within the reference's tolerance, the verify logits (bf16: 2e-2) and, in
bf16, the served speculative tokens under teacher forcing through the
reference's monolithic model.

Inside the port, bit for bit: the verify pass == W sequential decode steps
(logits and cache, stacked and paged); the stacked rollback leaves the
cache byte-equal to never having written it; the paged truncate restores
the page mapping; speculative == plain greedy across dense / MoE x stacked
/ paged, with self-speculation, and across a mid-serve re-budget that
turns the draft off and on again.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro
from repro.configs import get_smoke_config as jax_smoke
from repro.core import CLI2 as JCLI2
from repro.core import InferenceSetting as JSetting
from repro.core import TimingEstimator as JEstimator
from repro.core import build_graph as jax_graph
from repro.core import build_schedule as jax_schedule
from repro.core import run_install as jax_install
from repro.core.executor import PipelinedExecutor as JExecutor
from repro.core.planner import plan_draft_carve as jax_carve
from repro.core.serving import Request as JRequest
from repro.models import build_model as jax_build
from repro_torch import Session
from repro_torch.configs import get_smoke_config as torch_smoke
from repro_torch.core import (CLI2, PINNED_COMPUTE_KINDS, InferenceSetting,
                              TimingEstimator, build_graph, build_schedule,
                              choose_spec_k, estimate_spec_tps, estimate_tps,
                              plan_draft_carve, run_install)
from repro_torch.core.executor import PipelinedExecutor
from repro_torch.core.serving import Request
from repro_torch.models.api import params_from_numpy

torch.set_num_threads(1)

SETTING = dict(batch=2, context=64)
MAX_SEQ = 64
DRAFT = "qwen2-0.5b"


@pytest.fixture(scope="module")
def dbs():
    return jax_install(JCLI2, quick=True), run_install(CLI2, quick=True)


@pytest.fixture(scope="module")
def models():
    """(arch, dtype, seed) -> (jax cfg, port cfg, jax params, port
    params); seed 0 for targets, 1 for drafts (the reference's own)."""
    cache = {}

    def get(arch, dtype="bfloat16", seed=0):
        key = (arch, dtype, seed)
        if key not in cache:
            jcfg = jax_smoke(arch).replace(dtype=dtype)
            tcfg = torch_smoke(arch).replace(dtype=dtype)
            jp = jax_build(jcfg).init(jax.random.PRNGKey(seed))
            cache[key] = (jcfg, tcfg, jp,
                          params_from_numpy(jax.tree.map(np.asarray, jp)))
        return cache[key]

    return get


def total_bytes(cfg, eg=False):
    return sum(s.weight_bytes for s in build_graph(cfg, wdtype=2,
                                                   expert_granular=eg))


def make_sched(tcfg, db, frac=0.2):
    subs = build_graph(tcfg, wdtype=2)
    budget = int(sum(s.weight_bytes for s in subs) * frac) + 1
    return build_schedule(budget, subs, TimingEstimator(db, CLI2),
                          InferenceSetting(**SETTING))


def open_port(models, dbs, arch, frac, dtype="bfloat16", draft=False,
              **kw):
    _, tcfg, _, tp = models(arch, dtype)
    eg = kw.get("expert_granular", tcfg.moe is not None)
    if draft:
        _, dcfg, _, dp = models(DRAFT, dtype, seed=1)
        kw = dict(draft_cfg=dcfg, draft_params=dp, **kw)
    return Session.open(tcfg, CLI2, int(total_bytes(tcfg, eg) * frac) + 1,
                        InferenceSetting(**SETTING), db=dbs[1], params=tp,
                        max_seq=MAX_SEQ, device="cpu", **kw)


def open_ref(models, dbs, arch, frac, dtype, draft=False, **kw):
    jcfg, tcfg, jp, _ = models(arch, dtype)
    eg = kw.get("expert_granular", tcfg.moe is not None)
    if draft:
        dcfg, _, dp, _ = models(DRAFT, dtype, seed=1)
        kw = dict(draft_cfg=dcfg, draft_params=dp, **kw)
    return repro.Session.open(jcfg, JCLI2,
                              int(total_bytes(tcfg, eg) * frac) + 1,
                              JSetting(**SETTING), db=dbs[0], params=jp,
                              max_seq=MAX_SEQ, **kw)


def wave(cls, vocab, n=3, max_new=6):
    rng = np.random.RandomState(0)
    return [cls(rid=i, prompt=rng.randint(0, vocab, size=6 + 3 * i)
                .astype(np.int32), max_new_tokens=max_new)
            for i in range(n)]


def served(sess, cls=Request, **kw):
    reqs = wave(cls, sess.cfg.vocab, **kw)
    sess.serve(reqs, max_batch=2)
    return [r.generated for r in reqs]


# =================================================== multi-position verify
# No draft model here: the verify pass is a decode-append primitive and is
# right whatever proposes its tokens.
def _prefilled(ex, lens, kv=None, tensor=torch.as_tensor):
    """Per-slot prefill at staggered lengths; returns (kv, pos_vec)."""
    rng = np.random.RandomState(3)
    kv = ex.init_kv(len(lens)) if kv is None else kv
    for s, T in enumerate(lens):
        prompt = rng.randint(0, ex.cfg.vocab, size=(1, T)).astype(np.int32)
        _, kv, _ = ex.prefill(tensor(prompt), kv=kv, slot=s)
    return kv, np.asarray(lens, np.int32)


def _t(a):
    return torch.as_tensor(np.asarray(a))


@pytest.mark.parametrize("kv_layout", ["stacked", "paged"])
def test_verify_bitmatches_sequential_decode(models, dbs, kv_layout):
    """One W-wide verify pass == W sequential fused decode steps, bit for
    bit: every position's logits row and the final cache state. Staggered
    slot positions exercise the per-row base position."""
    _, cfg, _, params = models("yi-9b")
    sched = make_sched(cfg, dbs[1])
    W = 4

    def ex_():
        return PipelinedExecutor(cfg, params, sched, max_seq=MAX_SEQ,
                                 kv_layout=kv_layout, device="cpu")
    ex, ex2 = ex_(), ex_()
    act = _t([True, True])
    tokens = np.random.RandomState(7).randint(0, cfg.vocab, size=(2, W)) \
        .astype(np.int32)
    kv_seq, pos = _prefilled(ex, [6, 9])
    base = _t(pos)
    seq_logits = []
    for j in range(W):
        lg, kv_seq = ex._run_decode(_t(tokens[:, j:j + 1]), kv_seq,
                                    base + j, act, n_active=2)
        seq_logits.append(lg[:, -1])
    kv_ver, _ = _prefilled(ex2, [6, 9])
    vlog, kv_ver = ex2._run_verify(_t(tokens), kv_ver, base, act,
                                   n_active=2)
    for j in range(W):
        assert torch.equal(vlog[:, j], seq_logits[j]), \
            f"verify logits diverge from sequential decode at column {j}"
    if kv_layout == "stacked":
        assert torch.equal(kv_seq["k"], kv_ver["k"])
        assert torch.equal(kv_seq["v"], kv_ver["v"])
    else:
        assert (kv_seq.bids == kv_ver.bids).all()
        for layer in range(cfg.n_layers):
            a, b = kv_seq.layer_table(layer), kv_ver.layer_table(layer)
            assert torch.equal(kv_seq.k_pool[a], kv_ver.k_pool[b])
            assert torch.equal(kv_seq.v_pool[a], kv_ver.v_pool[b])
        nxt = _t(tokens[:, :1])
        a, _ = ex._run_decode(nxt, kv_seq, base + W, act, n_active=2)
        b, _ = ex2._run_decode(nxt, kv_ver, base + W, act, n_active=2)
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_verify_logits_match_reference(models, dbs, dtype):
    """The port's verify pass against the reference's on the same weights,
    prefix and window: f32 to f32 rounding, bf16 within 2e-2."""
    jcfg, cfg, jp, params = models("yi-9b", dtype)
    W = 4
    sched = make_sched(cfg, dbs[1])
    jsubs = jax_graph(jcfg, wdtype=2)
    jsched = jax_schedule(int(sum(s.weight_bytes for s in jsubs) * 0.2) + 1,
                          jsubs, JEstimator(dbs[0], JCLI2),
                          JSetting(**SETTING))
    tokens = np.random.RandomState(7).randint(0, cfg.vocab, size=(2, W)) \
        .astype(np.int32)
    ex = PipelinedExecutor(cfg, params, sched, max_seq=MAX_SEQ,
                           device="cpu")
    kv, pos = _prefilled(ex, [6, 9])
    got, _ = ex._run_verify(_t(tokens), kv, _t(pos), _t([True, True]), 2)
    jex = JExecutor(jcfg, jp, jsched, max_seq=MAX_SEQ)
    jkv, _ = _prefilled(jex, [6, 9], tensor=jnp.asarray)
    want, _ = jex._run_verify(jnp.asarray(tokens), jkv, jnp.asarray(pos),
                              jnp.asarray([True, True]), n_active=2)
    tol = dict(rtol=1e-4, atol=1e-4) if dtype == "float32" \
        else dict(rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(got.to(torch.float32).numpy(),
                               np.asarray(want, np.float32), **tol)
    assert ex.stats.verify_pass_stats == jex.stats.verify_pass_stats


def test_rollback_stacked_byte_identical_to_never_written(models, dbs):
    """After a W-wide verify pass, rolling back to ``pos + e`` leaves the
    stacked cache byte-equal to a cache that decoded only ``e`` tokens —
    e = 0 included (equal to never speculating)."""
    _, cfg, _, params = models("yi-9b")
    sched = make_sched(cfg, dbs[1])
    W = 4
    ex = PipelinedExecutor(cfg, params, sched, max_seq=MAX_SEQ, device="cpu")
    act = _t([True, True])
    tokens = np.random.RandomState(11).randint(0, cfg.vocab, size=(2, W)) \
        .astype(np.int32)
    for e in (0, 2):
        kv_ref, pos = _prefilled(ex, [6, 9])
        base = _t(pos)
        for j in range(e):
            _, kv_ref = ex._run_decode(_t(tokens[:, j:j + 1]), kv_ref,
                                       base + j, act, n_active=2)
        kv_v, _ = _prefilled(ex, [6, 9])
        _, kv_v = ex._run_verify(_t(tokens), kv_v, base, act, n_active=2)
        kv_v = ex.rollback_kv(kv_v, pos + e, np.array([True, True]))
        assert torch.equal(kv_ref["k"], kv_v["k"]), f"e={e}"
        assert torch.equal(kv_ref["v"], kv_v["v"]), f"e={e}"
    assert ex.stats.spec_rollbacks == 0   # the counter is serving-side


def test_rollback_paged_truncate_restores_mapping(models, dbs):
    """Paged rollback releases every block the verify pass made past the
    keep point (the allocator returns to the sequential run's state), the
    partial block's rejected offsets read zero, and continued decode equals
    never having speculated."""
    _, cfg, _, params = models("yi-9b")
    sched = make_sched(cfg, dbs[1])
    W, e = 4, 1

    def ex_():
        return PipelinedExecutor(cfg, params, sched, max_seq=MAX_SEQ,
                                 kv_layout="paged", device="cpu")
    ex, ex2 = ex_(), ex_()
    act = _t([True, True])
    tokens = np.random.RandomState(13).randint(0, cfg.vocab, size=(2, W)) \
        .astype(np.int32)
    kv_ref, pos = _prefilled(ex, [6, 9])
    base = _t(pos)
    for j in range(e):
        _, kv_ref = ex._run_decode(_t(tokens[:, j:j + 1]), kv_ref, base + j,
                                   act, n_active=2)
    kv_v, _ = _prefilled(ex2, [6, 9])
    _, kv_v = ex2._run_verify(_t(tokens), kv_v, base, act, n_active=2)
    assert len(kv_v.alloc.free) <= len(kv_ref.alloc.free)
    kv_v = ex2.rollback_kv(kv_v, pos + e, np.array([True, True]))
    assert len(kv_v.alloc.free) == len(kv_ref.alloc.free), \
        "rollback leaked (or over-freed) verify-pass blocks"
    assert (kv_v.bids == kv_ref.bids).all()
    for s, p in enumerate(pos + e):
        pid = kv_v.alloc.pid(int(kv_v.bids[0, s, p // 16]))
        assert not kv_v.k_pool[pid, :, p % 16:].any()
    for j in range(e, W):
        a, kv_ref = ex._run_decode(_t(tokens[:, j:j + 1]), kv_ref, base + j,
                                   act, n_active=2)
        b, kv_v = ex2._run_decode(_t(tokens[:, j:j + 1]), kv_v, base + j,
                                  act, n_active=2)
        assert torch.equal(a, b), f"post-rollback decode diverged at {j}"


def test_truncate_zeroes_a_host_resident_block(models, dbs):
    """A partially kept block that was evicted after its last write has
    its rejected offsets zeroed in the host copy, and reads back so."""
    _, cfg, _, params = models("yi-9b")
    ex = PipelinedExecutor(cfg, params, make_sched(cfg, dbs[1]),
                           max_seq=MAX_SEQ, kv_layout="paged", device="cpu")
    kv, _ = _prefilled(ex, [21])
    bid = int(kv.bids[0, 0, 1])
    kv.alloc.unpin([bid])
    while kv.alloc.resident(bid):      # evict until the block is on host
        kv.alloc.new_block()
    kv.truncate(0, 18)
    slot = kv.host[bid]
    assert not slot[:, :, 2:].any() and slot[:, :, :2].any()


def test_verify_pass_ledger_exact(models, dbs):
    """``streamed_bytes`` of every verify pass equals the tier's static
    plan bytes + demanded expert bytes + demanded page bytes, exactly, and
    each term equals the reference's (dense stacked, granular paged)."""
    for arch, kw in (("yi-9b", {}), ("qwen30b-a3b",
                                    {"kv_layout": "paged"})):
        jcfg, cfg, jp, params = models(arch, "float32")
        eg = cfg.moe is not None
        subs = build_graph(cfg, wdtype=2, expert_granular=eg)
        budget = int(sum(s.weight_bytes for s in subs) * 0.2) + 1
        sched = build_schedule(budget, subs, TimingEstimator(dbs[1], CLI2),
                               InferenceSetting(**SETTING))
        jsched = jax_schedule(budget, jax_graph(jcfg, wdtype=2,
                                                expert_granular=eg),
                              JEstimator(dbs[0], JCLI2), JSetting(**SETTING))
        ex = PipelinedExecutor(cfg, params, sched, max_seq=MAX_SEQ,
                               device="cpu", **kw)
        jex = JExecutor(jcfg, jp, jsched, max_seq=MAX_SEQ, **kw)
        tokens = np.random.RandomState(17).randint(0, cfg.vocab,
                                                   size=(2, 3))
        tokens = tokens.astype(np.int32)
        kv, pos = _prefilled(ex, [6, 9])
        _, kv = ex._run_verify(_t(tokens), kv, _t(pos), _t([True, True]),
                               n_active=2)
        jkv, _ = _prefilled(jex, [6, 9], tensor=jnp.asarray)
        jex._run_verify(jnp.asarray(tokens), jkv, jnp.asarray(pos),
                        jnp.asarray([True, True]), n_active=2)
        assert ex.stats.spec_verify_passes == 1
        (entry,) = ex.stats.verify_pass_stats
        assert entry["width"] == 3
        assert entry["streamed_bytes"] == (entry["static_plan_bytes"]
                                           + entry["demanded_expert_bytes"]
                                           + entry["demanded_page_bytes"])
        assert ex.stats.verify_pass_stats == jex.stats.verify_pass_stats


# =================================================== end-to-end serving
MATRIX = [
    # (target arch, session kwargs): the random-weight draft almost never
    # agrees, so every iteration rejects and rolls back, and the output
    # must still equal plain greedy decode
    ("yi-9b", {}),
    ("yi-9b", {"kv_layout": "paged", "overlap": False}),
    ("qwen30b-a3b", {"expert_granular": False}),
    ("qwen30b-a3b", {"kv_layout": "paged"}),   # expert-granular (default)
]
MATRIX_IDS = ["dense-stacked", "dense-paged-noovl", "moe-mono",
              "moe-granular-paged"]


@pytest.mark.parametrize("arch,kw", MATRIX, ids=MATRIX_IDS)
def test_spec_bit_identical_to_plain(models, dbs, arch, kw):
    sp = open_port(models, dbs, arch, 1.5, draft=True, spec_k=3, **kw)
    assert sp.spec_active, "the draft carve should be feasible at 1.5x"
    a = served(sp)
    b = served(open_port(models, dbs, arch, 1.5, **kw))
    assert a == b
    srv = sp.stats()["serving"]
    assert srv["spec_verify_passes"] > 0 and srv["spec_drafted"] > 0
    assert srv["spec_drafted"] == \
        srv["spec_accepted"] + srv["spec_rolled_back_tokens"]
    assert srv["draft"]["streamed_bytes"] == 0, "the draft must not stream"


@pytest.mark.parametrize("arch,kw", [MATRIX[0], MATRIX[3]],
                         ids=[MATRIX_IDS[0], MATRIX_IDS[3]])
def test_spec_matches_reference_fp32(models, dbs, arch, kw):
    """In f32, with the reference's target and draft weights: the served
    tokens, the speculation counters and every verify pass's ledger equal
    the reference's."""
    sp = open_port(models, dbs, arch, 1.5, "float32", draft=True, spec_k=3,
                   **kw)
    js = open_ref(models, dbs, arch, 1.5, "float32", draft=True, spec_k=3,
                  **kw)
    assert sp.draft_carve_bytes == js.draft_carve_bytes > 0
    assert served(sp) == served(js, JRequest)
    srv, jsrv = sp.stats()["serving"], js.stats()["serving"]
    for key in ("spec_k", "spec_drafted", "spec_accepted", "spec_rollbacks",
                "spec_rolled_back_tokens", "spec_verify_passes",
                "streamed_bytes", "iterations", "tiers_used"):
        assert srv[key] == jsrv[key], key
    assert srv["draft"] == jsrv["draft"]
    assert sp.executor.stats.verify_pass_stats \
        == js.executor.stats.verify_pass_stats
    if kw.get("kv_layout") == "paged":
        assert srv["paged_kv"] == {
            k: v for k, v in jsrv["paged_kv"].items()}


def test_self_speculation_accepts_and_stats_thread(models, dbs):
    """Draft == target: acceptance is high, and the counters thread
    ExecStats -> batcher.stats() -> Session.stats() consistently."""
    _, cfg, _, params = models("yi-9b")
    sp = open_port(models, dbs, "yi-9b", 1.8, draft_cfg=cfg, spec_k=3)
    sp._draft_params = sp.params
    assert sp.spec_active and sp.draft_carve_bytes > 0
    # max_new - 1 decode tokens divide by the window, so no request's
    # last window counts its unused drafts as rejected
    a = served(sp, max_new=9)
    b = served(open_port(models, dbs, "yi-9b", 1.8), max_new=9)
    assert a == b
    st = sp.stats()
    srv = st["serving"]
    assert st["spec_k"] == 3 and st["spec_active"]
    assert st["draft_carve_bytes"] == sp.draft_carve_bytes
    assert srv["accept_rate"] > 0.6
    assert srv["spec_accepted"] == sp._batcher.ex.stats.spec_accepted
    assert srv["spec_verify_passes"] == \
        sp._batcher.ex.stats.spec_verify_passes
    for entry in sp._batcher.ex.stats.verify_pass_stats:
        assert entry["streamed_bytes"] == (
            entry["static_plan_bytes"] + entry["demanded_expert_bytes"]
            + entry["demanded_page_bytes"]), entry
    est = sp.estimates(32)["spec"]
    assert est["spec_k"] == 3
    assert est["draft_carve_bytes"] == sp.draft_carve_bytes
    assert est["spec_tps"] > 0 and est["chosen_k"] >= 0
    # after serving, the estimate uses the observed rate, not the prior
    assert est["accept_rate"] == srv["accept_rate"]


def test_spec_survives_midserve_rebudget(models, dbs):
    """update_budget() mid-serve re-runs the draft carve: shrinking below
    feasibility turns speculation off (plain iterations), growing back
    turns it on again, and the tokens equal an uninterrupted plain run."""
    _, cfg, _, _ = models("yi-9b")
    total = total_bytes(cfg)
    sp = open_port(models, dbs, "yi-9b", 1.5, draft=True, spec_k=3)
    assert sp.spec_active
    a = wave(Request, cfg.vocab, n=3, max_new=8)
    sp.serve(a, max_batch=2, max_iterations=2)
    sp.update_budget(int(total * 0.3) + 1)       # the draft no longer fits
    assert not sp.spec_active and sp._batcher.spec_k == 0
    passes = sp.executor.stats.spec_verify_passes
    sp.serve([], max_iterations=2)
    assert sp.executor.stats.spec_verify_passes == passes
    sp.update_budget(int(total * 1.5) + 1)       # feasible again
    assert sp.spec_active and sp._batcher.spec_k == 3
    sp.serve([])
    assert sp.executor.stats.spec_verify_passes > passes
    b = served(open_port(models, dbs, "yi-9b", 1.5), n=3, max_new=8)
    assert [r.generated for r in a] == b


# =================================================== degradation to today
def plan_sig(schedule):
    return [(t, [(p.sub.name, p.residency, p.engine, p.streamed)
                 for p in schedule.tiers[t].plan.placements])
            for t in sorted(schedule.tiers)]


def test_spec_k0_and_infeasible_pick_todays_plans(models, dbs):
    """spec_k=0, and an infeasible draft at any k, give the schedule and
    estimates of a session opened with no draft, and serve the same
    tokens; the reference agrees on every plan."""
    base = open_port(models, dbs, "yi-9b", 0.2)
    k0 = open_port(models, dbs, "yi-9b", 0.2, draft=True, spec_k=0)
    infeasible = open_port(models, dbs, "yi-9b", 0.2, draft=True, spec_k=4)
    assert not k0.spec_active and not infeasible.spec_active
    assert infeasible.draft_schedule is None
    assert infeasible.draft_carve_bytes == 0
    for other in (k0, infeasible):
        assert plan_sig(other.schedule) == plan_sig(base.schedule)
        assert other.schedule.kv_pool_bytes == base.schedule.kv_pool_bytes
    assert k0.estimates(32) == base.estimates(32)
    jbase = open_ref(models, dbs, "yi-9b", 0.2, "bfloat16")
    assert plan_sig(base.schedule) == plan_sig(jbase.schedule)
    assert served(infeasible) == served(base)
    srv = infeasible.stats()["serving"]
    assert srv["spec_k"] == 0 and srv["spec_verify_passes"] == 0


# =================================================== open() contracts
def test_contract_vocab_mismatch_raises(models, dbs):
    draft = torch_smoke(DRAFT).replace(vocab=512)
    with pytest.raises(ValueError, match="vocab"):
        open_port(models, dbs, "yi-9b", 1.5, draft_cfg=draft, spec_k=2)


def test_contract_tokenizer_mismatch_raises(dbs):
    draft = torch_smoke(DRAFT).replace(tokenizer="qwen2")
    cfg = torch_smoke("yi-9b").replace(tokenizer="yi")
    budget = int(total_bytes(cfg) * 1.5) + 1
    with pytest.raises(ValueError, match="tokenizer"):
        Session.open(cfg, CLI2, budget, InferenceSetting(**SETTING),
                     db=dbs[1], max_seq=MAX_SEQ, device="cpu",
                     draft_cfg=draft, spec_k=2)
    # both declaring the same tokenizer is fine (planning only)
    s = Session.open(cfg, CLI2, budget, InferenceSetting(**SETTING),
                     db=dbs[1], max_seq=MAX_SEQ, device="cpu",
                     draft_cfg=draft.replace(tokenizer="yi"), spec_k=2)
    assert s.spec_k == 2


def test_contract_sampling_and_k(models, dbs):
    draft = torch_smoke(DRAFT)
    with pytest.raises(ValueError, match="greedy"):
        open_port(models, dbs, "yi-9b", 1.5, draft_cfg=draft, spec_k=2,
                  sampling="topk")
    with pytest.raises(ValueError, match="draft_cfg"):
        open_port(models, dbs, "yi-9b", 1.5, spec_k=2)
    with pytest.raises(ValueError, match="spec_k"):
        open_port(models, dbs, "yi-9b", 1.5, draft_cfg=draft, spec_k=-1)
    with pytest.raises(ValueError, match="greedy"):
        open_port(models, dbs, "yi-9b", 1.5, sampling="topk")


# =================================================== planner
def test_estimate_spec_tps_k0_is_baseline(models, dbs):
    _, cfg, _, _ = models("yi-9b")
    sched = make_sched(cfg, dbs[1])
    assert estimate_spec_tps(sched, draft_step_s=1e-3, accept_rate=0.7,
                             k=0, batch=2) == estimate_tps(sched, 2)


def test_choose_spec_k_degrades_and_improves(models, dbs):
    _, cfg, _, _ = models("yi-9b")
    sched = make_sched(cfg, dbs[1])
    assert choose_spec_k(sched, draft_step_s=0.0, accept_rate=1.0,
                         k_max=4) == 4
    assert choose_spec_k(sched, draft_step_s=0.0, accept_rate=0.0) == 0
    assert choose_spec_k(sched, draft_step_s=1e6, accept_rate=1.0) == 0


def test_plan_draft_carve_matches_reference(models, dbs):
    """The carve's bytes and the draft schedule's pins equal the
    reference's; every draft compute sub-layer is pinned; a budget the
    carve would starve the target under is infeasible."""
    _, cfg, _, _ = models("yi-9b")
    _, draft, _, _ = models(DRAFT)
    tsubs, dsubs = build_graph(cfg, wdtype=2), build_graph(draft, wdtype=2)
    est = TimingEstimator(dbs[1], CLI2)
    setting = InferenceSetting(**SETTING)
    total = sum(s.weight_bytes for s in tsubs)
    jest = JEstimator(dbs[0], JCLI2)
    jt, jd = jax_graph(jax_smoke("yi-9b"), wdtype=2), \
        jax_graph(jax_smoke(DRAFT), wdtype=2)
    for frac in (0.2, 0.6, 1.5):
        budget = int(total * frac) + 1
        sched, carve = plan_draft_carve(budget, dsubs, tsubs, est, setting)
        jsched, jcarve = jax_carve(budget, jd, jt, jest, JSetting(**SETTING))
        assert carve == jcarve and isinstance(carve, int)
        assert (sched is None) == (jsched is None)
        if sched is not None:
            assert plan_sig(sched) == plan_sig(jsched)
    sched, carve = plan_draft_carve(int(total * 1.5) + 1, dsubs, tsubs,
                                    est, setting)
    pinned = {p.sub.name for p in sched.pinned_placements()}
    assert all(s.name in pinned for s in dsubs
               if s.kind in PINNED_COMPUTE_KINDS)
    assert plan_draft_carve(carve + 1, dsubs, tsubs, est, setting) \
        == (None, 0)
    assert plan_draft_carve(0, dsubs, tsubs, est, setting) == (None, 0)


def test_draft_schedule_pins_everything_and_streams_nothing(models, dbs):
    """The session's draft runner is wholly pinned: no prefetcher, and the
    draft's executor never moves a streamed byte while serving."""
    sp = open_port(models, dbs, "yi-9b", 1.5, draft=True, spec_k=2)
    served(sp)
    dec = sp.spec_decoder(2)
    assert dec.ex.prefetch is None
    assert dec.ex.stats.streamed_bytes == 0 and dec.ex.stats.at_use_bytes == 0
    assert dec.ex.stats.spec_verify_passes > 0


@pytest.mark.parametrize("kv_layout", ["stacked", "paged"])
def test_spec_bf16_teacher_forced_against_reference(models, dbs, kv_layout):
    """bf16: XLA and torch round at other places, so the port's
    speculative tokens are fed through the reference's monolithic model:
    each is its position's argmax within 2e-2 of the logits' scale."""
    jcfg, _, jp, _ = models("yi-9b")
    sp = open_port(models, dbs, "yi-9b", 1.5, draft=True, spec_k=3,
                   kv_layout=kv_layout)
    reqs = wave(Request, jcfg.vocab)
    sp.serve(reqs, max_batch=2)
    assert sp.stats()["serving"]["spec_verify_passes"] > 0
    jm = jax_build(jcfg)
    for r in reqs:
        seq = np.concatenate([r.prompt, r.generated[:-1]]) \
            .astype(np.int32)[None]
        logits, _ = jm.apply(jp, {"tokens": jnp.asarray(seq)})
        z = np.asarray(logits[0, len(r.prompt) - 1:], np.float32)
        gap = z.max(axis=1) - z[np.arange(len(r.generated)), r.generated]
        assert gap.max() <= 2e-2 * np.abs(z).max(), (gap, r.generated)
