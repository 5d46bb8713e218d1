"""The port's paged KV cache against the JAX package, on the CPU (smoke
yi-9b, qwen30b-a3b monolithic and expert-granular; the JAX package's
weights through the numpy param bridge; numpy-seeded requests; the
reference's schedules, which both packages plan alike).

Against the reference, exactly, in f32: served tokens under an ample and a
forced-eviction pool, and the page counters (``page_faults``,
``evictions``, ``demanded_page_bytes``, ``prefix_hits``,
``prefix_hit_blocks``, ``cow_copies``), the streamed-bytes ledger with its
``kv`` bucket, the planner's pool size and prefix-hit TTFT, the session's
pool pages; the ``PageAllocator`` under random operation sequences (page
ids, victims, ``check()``); the paged engine steps' scatter cells and
outputs. In bf16, the tokens served under forced eviction under teacher
forcing through the reference's monolithic model, within 2e-2.

Inside the port, bit for bit, in bf16: paged == stacked with an ample pool
and with ``TINY_POOL`` pages; overlap == sync on paged; across a mid-serve
re-budget; prefix hits; fused == per-slot; the paged decode step == the
stacked one.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import repro
from repro.configs import get_smoke_config as jax_smoke
from repro.core import CLI2 as JCLI2
from repro.core import InferenceSetting as JSetting
from repro.core import TimingEstimator as JEstimator
from repro.core import build_graph as jax_graph
from repro.core import build_schedule as jax_schedule
from repro.core import run_install as jax_install
from repro.core.engine import SubLayerEngine
from repro.core.kvpaged import PageAllocator as JPageAllocator
from repro.core.kvpaged import PagePoolFull as JPagePoolFull
from repro.core.serving import ContinuousBatcher as JBatcher
from repro.core.serving import Request as JRequest
from repro.models import build_model as jax_build
from repro_torch import Session
from repro_torch.configs import get_smoke_config as torch_smoke
from repro_torch.core import (CLI2, InferenceSetting, TimingEstimator,
                              build_graph, build_schedule, estimate_ttft,
                              run_install)
from repro_torch.core import engine as teng
from repro_torch.core.kvpaged import PageAllocator, PagedKVCache, PagePoolFull
from repro_torch.core.serving import ContinuousBatcher, Request
from repro_torch.models.api import params_from_numpy

torch.set_num_threads(1)

# the forced-eviction pool: smaller than the live block set of every arch
# (2 layers x 2 slots x up to 2 blocks), so decode keeps evicting and
# restoring, but at least one layer's working set, so passes finish
TINY_POOL = 4
ARCHES = [("yi-9b", False), ("qwen30b-a3b", False), ("qwen30b-a3b", True)]
ARCH_IDS = ["dense", "moe-mono", "moe-granular"]
MAX_SEQ, MAX_BATCH = 64, 2
COUNTERS = ("page_faults", "evictions", "evicted_page_bytes",
            "demanded_page_bytes", "cow_copies", "prefix_queries",
            "prefix_hits", "prefix_hit_blocks", "prefix_entries",
            "resident_blocks", "host_blocks", "n_pages")


@pytest.fixture(scope="module")
def dbs():
    return jax_install(JCLI2, quick=True), run_install(CLI2, quick=True)


@pytest.fixture(scope="module")
def built(dbs):
    """(arch, granular, dtype) -> both packages' configs, params and
    schedules (budget 0.2x of the graph's weight bytes)."""
    cache = {}

    def get(arch, eg=False, dtype="bfloat16"):
        key = (arch, eg, dtype)
        if key not in cache:
            jcfg = jax_smoke(arch).replace(dtype=dtype)
            tcfg = torch_smoke(arch).replace(dtype=dtype)
            jp = jax_build(jcfg).init(jax.random.PRNGKey(0))
            tp = params_from_numpy(jax.tree.map(np.asarray, jp))
            setting = dict(batch=MAX_BATCH, context=MAX_SEQ)
            jsubs = jax_graph(jcfg, wdtype=2, expert_granular=eg)
            budget = int(sum(s.weight_bytes for s in jsubs) * 0.2) + 1
            jsched = jax_schedule(budget, jsubs, JEstimator(dbs[0], JCLI2),
                                  JSetting(**setting))
            tsched = build_schedule(
                budget, build_graph(tcfg, wdtype=2, expert_granular=eg),
                TimingEstimator(dbs[1], CLI2), InferenceSetting(**setting))
            cache[key] = (jcfg, tcfg, jp, tp, jsched, tsched)
        return cache[key]

    return get


def staggered(cls, vocab, n=5, base_len=6, max_new=4):
    """Different prompt lengths put the slots at different cache
    positions; n > max_batch staggers admissions across iterations."""
    rng = np.random.RandomState(0)
    return [cls(rid=i, prompt=rng.randint(0, vocab, size=base_len + 3 * i)
                .astype(np.int32), max_new_tokens=max_new)
            for i in range(n)]


def serve_port(model, reqs=None, max_batch=MAX_BATCH, **kw):
    _, tcfg, _, tp, _, tsched = model
    reqs = staggered(Request, tcfg.vocab) if reqs is None else reqs
    b = ContinuousBatcher(tcfg, tp, tsched, max_batch=max_batch,
                          max_seq=MAX_SEQ, device="cpu", **kw)
    b.serve(reqs)
    return b, [r.generated for r in reqs]


def serve_ref(model, reqs=None, max_batch=MAX_BATCH, **kw):
    jcfg, _, jp, _, jsched, _ = model
    reqs = staggered(JRequest, jcfg.vocab) if reqs is None else reqs
    b = JBatcher(jcfg, jp, jsched, max_batch=max_batch, max_seq=MAX_SEQ,
                 **kw)
    b.serve(reqs)
    return b, [r.generated for r in reqs]


def _same_counters(tb, jb):
    t, j = tb.stats(), jb.stats()
    for key in COUNTERS:
        assert t["paged_kv"][key] == j["paged_kv"][key], key
    for key in ("page_faults", "demanded_page_bytes", "streamed_bytes",
                "streamed_bytes_by_dtype", "tiers_used", "iterations",
                "engine_calls"):
        assert t[key] == j[key], key


class _Calls:
    """Counts the calls of ``module.name`` while installed."""

    def __init__(self, monkeypatch, module, name):
        real = getattr(module, name)
        self.n = 0

        def counted(*a, **kw):
            self.n += 1
            return real(*a, **kw)
        monkeypatch.setattr(module, name, counted)


# ------------------------------------------------------------ bit-identity
@pytest.mark.parametrize("arch,eg", ARCHES, ids=ARCH_IDS)
def test_paged_ample_pool_bit_identical(arch, eg, built, monkeypatch):
    """The default pool (the full stacked demand) never evicts: paged is a
    pure layout change, token for token equal to stacked serving with
    staggered admissions, and in f32 equal to the reference's paged
    serving with the same counters."""
    model = built(arch, eg)
    _, ref = serve_port(model)
    dec = _Calls(monkeypatch, teng, "attn_decode_paged_step")
    pre = _Calls(monkeypatch, teng, "attn_prefill_paged_step")
    b, got = serve_port(model, kv_layout="paged")
    assert got == ref
    st = b.stats()["paged_kv"]
    assert st["evictions"] == 0 and st["page_faults"] == 0
    # the paged steps ran (this was not stacked in disguise)
    assert dec.n >= 1 and pre.n >= 1
    f32 = built(arch, eg, "float32")
    tb, tgot = serve_port(f32, kv_layout="paged")
    jb, jgot = serve_ref(f32, kv_layout="paged")
    assert tgot == jgot
    _same_counters(tb, jb)


@pytest.mark.parametrize("arch,eg", ARCHES, ids=ARCH_IDS)
def test_paged_forced_eviction_bit_identical(arch, eg, built):
    """A pool far below the live block set forces LRU eviction to host and
    restores mid-decode: tokens do not move, the page ledger balances (every
    demanded byte is an evicted block touched again), and in f32 tokens and
    counters equal the reference's."""
    model = built(arch, eg)
    _, ref = serve_port(model)
    b, got = serve_port(model, kv_layout="paged", kv_pool_pages=TINY_POOL)
    assert got == ref
    kv = b.kv
    st = b.stats()["paged_kv"]
    assert st["evictions"] > 0, "tiny pool never evicted"
    assert st["page_faults"] > 0, "evicted pages were never restored"
    assert st["page_faults"] == kv.alloc.restores
    assert st["demanded_page_bytes"] == st["page_faults"] * kv.block_bytes
    assert st["evicted_page_bytes"] == st["evictions"] * kv.block_bytes
    assert kv.alloc.restores <= kv.alloc.evictions
    assert kv.host_pages.chunks == 1     # slots reused, not re-allocated
    f32 = built(arch, eg, "float32")
    tb, tgot = serve_port(f32, kv_layout="paged", kv_pool_pages=TINY_POOL)
    jb, jgot = serve_ref(f32, kv_layout="paged", kv_pool_pages=TINY_POOL)
    assert tgot == jgot
    _same_counters(tb, jb)
    assert tb.kv.alloc.restores == jb.kv.alloc.restores
    assert tb.kv.alloc.writebacks == jb.kv.alloc.writebacks


def test_paged_overlap_off_bit_identical(built):
    """overlap=False: restores take the at-use path, and still equal
    stacked serving and the pipelined paged run under forced eviction."""
    model = built("yi-9b")
    _, ref = serve_port(model, overlap=False)
    b, sync = serve_port(model, kv_layout="paged", kv_pool_pages=TINY_POOL,
                         overlap=False)
    _, ovl = serve_port(model, kv_layout="paged", kv_pool_pages=TINY_POOL)
    assert sync == ref == ovl
    assert b.stats()["paged_kv"]["evictions"] > 0
    assert b.ex.stats.streamed_bytes_by_dtype.get("kv", 0) \
        == b.ex.stats.demanded_page_bytes > 0


def test_paged_fused_equals_per_slot(built):
    model = built("qwen30b-a3b", True)
    _, fused = serve_port(model, kv_layout="paged", kv_pool_pages=TINY_POOL)
    _, per_slot = serve_port(model, kv_layout="paged",
                             kv_pool_pages=TINY_POOL, fused=False)
    assert fused == per_slot


def test_paged_across_mid_serve_rebudget(built, dbs):
    """Pause a paged serve with slots in flight, halve the budget (live
    executor rebind), drain: tokens equal an uninterrupted stacked run at
    the final budget, and the page pool and table survive."""
    _, tcfg, _, tp, _, _ = built("yi-9b")
    total = sum(s.weight_bytes for s in build_graph(tcfg, wdtype=2))

    def open_s(frac, **kw):
        return Session.open(tcfg, CLI2, int(total * frac) + 1,
                            InferenceSetting(batch=2, context=64),
                            db=dbs[1], params=tp, max_seq=64, device="cpu",
                            **kw)

    def reqs(n=2, max_new=8):
        rng = np.random.RandomState(0)
        return [Request(rid=i, prompt=rng.randint(0, tcfg.vocab,
                                                  size=6 + 3 * i)
                        .astype(np.int32), max_new_tokens=max_new)
                for i in range(n)]

    live = open_s(2.0, kv_layout="paged")
    a = reqs()
    live.serve(a, max_batch=2, max_iterations=2)
    assert any(sl is not None for sl in live.batcher().slots)
    kv = live.batcher().kv
    assert isinstance(kv, PagedKVCache)
    diff = live.update_budget(int(total * 1.0) + 1)
    assert diff.to_evict, "fixture bug: budget step did not change pins"
    live.serve([])
    assert live.batcher().kv is kv, "rebind rebuilt the page pool"
    fresh = open_s(1.0)
    b = reqs()
    fresh.serve(b, max_batch=2)
    assert [r.generated for r in a] == [r.generated for r in b]
    st = live.stats()
    assert st["kv_layout"] == "paged"
    assert "paged_kv" in st["serving"]
    assert "page_faults" in st["executor"]


def test_paged_bf16_teacher_forced_against_reference(built):
    """bf16 under forced eviction: XLA and torch round at other places, so
    the port's paged tokens are fed through the reference's monolithic
    model: each is its position's argmax within 2e-2 of the logits'
    scale."""
    model = built("qwen30b-a3b", True)
    jcfg, _, jp = model[:3]
    reqs = staggered(Request, jcfg.vocab)
    serve_port(model, reqs, kv_layout="paged", kv_pool_pages=TINY_POOL)
    jm = jax_build(jcfg)
    for r in reqs:
        seq = np.concatenate([r.prompt, r.generated[:-1]]) \
            .astype(np.int32)[None]
        logits, _ = jm.apply(jp, {"tokens": jnp.asarray(seq)})
        z = np.asarray(logits[0, len(r.prompt) - 1:], np.float32)
        gap = z.max(axis=1) - z[np.arange(len(r.generated)), r.generated]
        assert gap.max() <= 2e-2 * np.abs(z).max(), (gap, r.generated)


# ------------------------------------------------------------ prefix cache
def _shared_prefix_reqs(cls, vocab, seed=4):
    """Three admissions sharing a 32-token (2 full blocks) system prompt."""
    shared = np.random.RandomState(3).randint(0, vocab, size=32) \
        .astype(np.int32)
    r = np.random.RandomState(seed)
    return [cls(rid=i, prompt=np.concatenate(
        [shared, r.randint(0, vocab, size=5 + i).astype(np.int32)]),
        max_new_tokens=3) for i in range(3)]


def test_prefix_hit_bit_identical_with_exact_counters(built):
    """The 2nd and 3rd admissions map the cached blocks instead of
    prefilling them: 2 hits x 2 blocks, no copy-on-write, tokens equal to
    the stacked cold prefill; in f32 tokens and counters equal the
    reference's."""
    model = built("yi-9b")
    cfg = model[1]
    _, cold = serve_port(model, _shared_prefix_reqs(Request, cfg.vocab),
                         max_batch=1)
    bp, warm = serve_port(model, _shared_prefix_reqs(Request, cfg.vocab),
                          max_batch=1, kv_layout="paged")
    assert warm == cold
    st = bp.stats()["paged_kv"]
    assert st["prefix_queries"] == 3
    assert st["prefix_hits"] == 2, st
    assert st["prefix_hit_blocks"] == 2 * (32 // st["page_size"]), st
    assert st["cow_copies"] == 0
    pf = bp.ex.stats.prefill_stats
    assert [p["prefix_tokens"] for p in pf] == [0, 32, 32]
    f32 = built("yi-9b", False, "float32")
    tb, tgot = serve_port(f32, _shared_prefix_reqs(Request, cfg.vocab),
                          max_batch=1, kv_layout="paged")
    jb, jgot = serve_ref(f32, _shared_prefix_reqs(JRequest, cfg.vocab),
                         max_batch=1, kv_layout="paged")
    assert tgot == jgot
    _same_counters(tb, jb)


# ------------------------------------------------------------ byte ledger
def test_page_demand_joins_streaming_ledger(built):
    """Pages are the second demand-streamed shard kind beside cold
    experts: demanded page bytes ride the demand pool and land in
    ``streamed_bytes`` under their own ``kv`` bucket, so ``streamed ==
    static plan + demanded experts + demanded pages`` holds exactly, and in
    f32 every term equals the reference's."""
    model = built("qwen30b-a3b", True)
    _, ref = serve_port(model)
    b, got = serve_port(model, kv_layout="paged", kv_pool_pages=TINY_POOL)
    assert got == ref
    ex = b.ex.stats
    assert ex.demanded_page_bytes > 0 and ex.demanded_expert_bytes > 0
    assert ex.streamed_bytes_by_dtype.get("kv", 0) == ex.demanded_page_bytes
    static = {}
    for t in ex.tiers_used:
        for p in b.ex.schedule.tiers[t].plan.static_stream_order():
            if p.sub.name not in b.ex._pinned:
                static[p.sub.name] = static.get(p.sub.name, 0) \
                    + p.sub.weight_bytes
    assert ex.streamed_bytes == sum(static.values()) \
        + ex.demanded_expert_bytes + ex.demanded_page_bytes
    # each layer's restores ride the demand pool as one entry: at least
    # one entry, never more than the faults
    shard = max(p.sub.weight_bytes for t in ex.tiers_used
                for p in b.ex.schedule.tiers[t].plan.placements
                if p.sub.kind == "moe_expert")
    page_entries = b.ex.prefetch.stats.demanded_sublayers \
        - ex.demanded_expert_bytes // shard
    assert 1 <= page_entries <= ex.page_faults
    f32 = built("qwen30b-a3b", True, "float32")
    tb, tgot = serve_port(f32, kv_layout="paged", kv_pool_pages=TINY_POOL)
    jb, jgot = serve_ref(f32, kv_layout="paged", kv_pool_pages=TINY_POOL)
    assert tgot == jgot
    _same_counters(tb, jb)
    assert tb.ex.stats.demanded_expert_bytes \
        == jb.ex.stats.demanded_expert_bytes
    assert tb.ex.stats.page_faults == jb.ex.stats.page_faults


# ------------------------------------------------------------ planner
def test_planner_sizes_pool_and_prices_prefix_hits(built):
    """The page pool joins the tier table as the reference sizes it, and
    ``estimate_ttft``'s prefix-hit term prices exactly the uncovered
    suffix."""
    jcfg, tcfg, _, _, jsched, sched = built("yi-9b")
    assert sched.kv_page_size == jsched.kv_page_size == 16
    assert sched.kv_pool_bytes == jsched.kv_pool_bytes
    setting = InferenceSetting(batch=2, context=64)
    kv_subs = [s for s in build_graph(tcfg, wdtype=2) if s.kind == "kv"]
    block = max(s.kv_bytes_per_token for s in kv_subs) * sched.kv_page_size
    floor = (2 * setting.batch * (setting.context // sched.kv_page_size)
             + 1) * block
    assert sched.kv_pool_bytes >= floor
    from repro.core.planner import estimate_ttft as jttft
    for mode in ("chunk_major", "layer_major"):
        for frac in (0.0, 0.5, 0.75):
            assert estimate_ttft(sched, 64, mode=mode,
                                 prefix_hit_frac=frac) \
                == jttft(jsched, 64, mode=mode, prefix_hit_frac=frac)
    assert estimate_ttft(sched, 64, mode="chunk_major",
                         prefix_hit_frac=0.5) \
        == estimate_ttft(sched, 32, mode="chunk_major")
    with pytest.raises(ValueError, match="prefix_hit_frac"):
        estimate_ttft(sched, 64, prefix_hit_frac=1.5)


@pytest.mark.parametrize("frac", [0.2, 2.0])
def test_session_pool_pages_and_estimates_match_reference(built, dbs, frac):
    """A paged session's pool (the planner's ``kv_pool_bytes`` in pages)
    and its ``estimates(isl, prefix_hit_frac=)`` equal the reference's; a
    stacked session refuses a prefix-hit estimate."""
    jcfg, tcfg, jp, tp, _, _ = built("yi-9b")
    total = sum(s.weight_bytes for s in build_graph(tcfg, wdtype=2))
    kw = dict(max_seq=MAX_SEQ, kv_layout="paged")
    s = Session.open(tcfg, CLI2, int(total * frac) + 1,
                     InferenceSetting(batch=2, context=64), db=dbs[1],
                     params=tp, device="cpu", **kw)
    js = repro.Session.open(jcfg, JCLI2, int(total * frac) + 1,
                            JSetting(batch=2, context=64), db=dbs[0],
                            params=jp, **kw)
    assert s._effective_kv_pool_pages() == js._effective_kv_pool_pages()
    assert s.executor.kv_pool_pages == js.executor.kv_pool_pages
    assert s.estimates(64, prefix_hit_frac=0.75) == {
        k: v for k, v in js.estimates(64, prefix_hit_frac=0.75).items()
        if k in s.estimates(64)}
    stacked = Session.open(tcfg, CLI2, int(total * frac) + 1, db=dbs[1],
                           device="cpu")
    with pytest.raises(ValueError, match="prefix_hit_frac"):
        stacked.estimates(64, prefix_hit_frac=0.5)


def test_generate_paged_equals_stacked(built, dbs):
    """``Session.generate`` on a paged session: batch prefill into fresh
    pages, then the fused decode loop; tokens equal the stacked
    session's."""
    _, tcfg, _, tp, _, _ = built("yi-9b")
    total = sum(s.weight_bytes for s in build_graph(tcfg, wdtype=2))
    prompts = np.random.RandomState(1).randint(0, tcfg.vocab, (2, 21))
    out = {}
    for layout in ("stacked", "paged"):
        s = Session.open(tcfg, CLI2, int(total * 0.2) + 1,
                         InferenceSetting(batch=2, context=64), db=dbs[1],
                         params=tp, max_seq=MAX_SEQ, device="cpu",
                         kv_layout=layout)
        out[layout] = s.generate(prompts, 5)
    assert np.array_equal(out["stacked"], out["paged"])


# ------------------------------------------------------------ lifecycle
def test_retire_and_cancel_unmap_pages(built):
    """Retiring and cancelling unmap a slot's pages; afterwards only the
    prefix cache's own blocks stay alive, each held once."""
    model = built("yi-9b")
    cfg = model[1]
    reqs = _shared_prefix_reqs(Request, cfg.vocab)
    b = ContinuousBatcher(cfg, model[3], model[5], max_batch=2,
                          max_seq=MAX_SEQ, device="cpu", kv_layout="paged")
    b.serve(reqs, max_iterations=1)
    assert b.cancel(1) == "active"
    b.serve([])
    kv = b.kv
    entries = kv.stats.prefix_entries
    assert entries == 2
    assert len(kv.alloc.blocks) == entries * cfg.n_layers
    assert all(blk.refs == 1 for blk in kv.alloc.blocks.values())
    assert (kv.bids == -1).all()
    kv.alloc.check()


# ------------------------------------------------------------ failure modes
def test_pool_below_working_set_raises(built):
    """A pool smaller than one layer's pinned working set cannot make
    progress: the allocator fails loudly (PagePoolFull names the knob)."""
    model = built("yi-9b")
    reqs = staggered(Request, model[1].vocab, n=2, base_len=20)
    with pytest.raises(PagePoolFull, match="pinned"):
        serve_port(model, reqs, kv_layout="paged", kv_pool_pages=1)


def test_kv_layout_knob_validation(built, dbs):
    model = built("yi-9b")
    _, tcfg, _, tp, _, tsched = model
    with pytest.raises(ValueError, match="kv_layout"):
        ContinuousBatcher(tcfg, tp, tsched, max_batch=2, max_seq=64,
                          kv_layout="ring", device="cpu")
    with pytest.raises(ValueError, match="kv_layout"):
        Session.open(tcfg, CLI2, 1 << 20, db=dbs[1], device="cpu",
                     kv_layout="ring")
    b = ContinuousBatcher(tcfg, tp, tsched, max_batch=2, max_seq=64,
                          device="cpu")
    with pytest.raises(ValueError, match="kv_layout"):
        ContinuousBatcher(tcfg, executor=b.ex, kv_layout="paged")


# ------------------------------------------------------------ engine steps
def _step_inputs(cfg, B=2, S=32, ps=16, seed=5):
    rng = np.random.RandomState(seed)
    nblk = S // ps
    KV, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    n_pages = B * nblk + 2
    pool = rng.randn(2, n_pages, KV, ps, hd).astype(np.float32)
    pool[:, 0] = 0
    # slot b's blocks on pages 1 + b*nblk + j, shuffled
    perm = rng.permutation(np.arange(1, B * nblk + 1))
    table = perm.reshape(B, nblk).astype(np.int32)
    return rng, pool, table


@pytest.mark.parametrize("step", ["decode", "prefill"])
def test_paged_steps_match_reference_engine(built, step):
    """The paged decode and prefill steps against the reference engine's,
    in f32, on the same weights, pools and tables: the scatter writes the
    same (page, offset) cells (NumPy's advanced-index rule: the broadcast
    index dims come first), an inactive slot or a padded position writes
    only the null page, and outputs and pools agree to f32 rounding."""
    jcfg, tcfg, jp, tp, _, _ = built("yi-9b", False, "float32")
    rng, pool, table = _step_inputs(tcfg)
    w_np = {"attn": jax.tree.map(lambda a: np.asarray(a[0]),
                                 jp["layers"]["attn"]),
            "ln1": np.asarray(jp["layers"]["ln1"][0])}
    w_t = params_from_numpy(w_np)
    eng_j = SubLayerEngine(jcfg)
    kj, vj = (jnp.asarray(pool[i], jnp.bfloat16) for i in range(2))
    kt, vt = (torch.from_numpy(pool[i]).to(torch.bfloat16)
              for i in range(2))
    before_pools = (kt.to(torch.float32).numpy().copy(),
                    vt.to(torch.float32).numpy().copy())
    if step == "decode":
        x = rng.randn(2, 1, tcfg.d_model).astype(np.float32)
        pos = np.array([19, 7], np.int32)
        active = np.array([True, False])
        out_j, kj, vj = eng_j._attn_decode_paged_step(
            w_np, jnp.asarray(x), kj, vj, jnp.asarray(table),
            jnp.asarray(pos), jnp.asarray(active))
        out_t = teng.attn_decode_paged_step(
            tcfg, w_t, torch.from_numpy(x), kt, vt,
            torch.from_numpy(table).long(), torch.from_numpy(pos),
            torch.from_numpy(active))
        written = {(int(table[0, 19 // 16]), 19 % 16), (0, 7)}
    else:
        x = rng.randn(2, 8, tcfg.d_model).astype(np.float32)
        pos, valid = 12, 5
        out_j, kj, vj = eng_j._attn_prefill_paged_step(
            w_np, jnp.asarray(x), kj, vj, jnp.asarray(table),
            jnp.asarray(pos, jnp.int32), jnp.asarray(valid, jnp.int32))
        out_t = teng.attn_prefill_paged_step(
            tcfg, w_t, torch.from_numpy(x), kt, vt,
            torch.from_numpy(table).long(), pos, valid)
        written = {(int(table[b, (pos + t) // 16]), (pos + t) % 16)
                   for b in range(2) for t in range(valid)} \
            | {(0, (pos + t) % 16) for t in range(valid, 8)}
    for before, tj, tt in zip(before_pools, (kj, vj), (kt, vt)):
        aj = np.asarray(tj, np.float32)
        at = tt.to(torch.float32).numpy()
        changed_j = {(p, o) for p, o in zip(*np.nonzero(
            (aj != before).any(axis=(1, 3))))}
        changed_t = {(p, o) for p, o in zip(*np.nonzero(
            (at != before).any(axis=(1, 3))))}
        assert changed_t == changed_j
        assert {c for c in changed_t if c[0] != 0} \
            == {c for c in written if c[0] != 0}
        # the sink aside, the pools agree to one bf16 rounding
        np.testing.assert_allclose(at[1:], aj[1:], rtol=1e-2, atol=1e-2)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j),
                               rtol=2e-4, atol=2e-4)


def test_paged_decode_step_equals_stacked_step(built):
    """The paged decode step on a pool laid out as a stacked cache's pages
    equals the stacked step bit for bit, cache contents included; the
    inactive slot's write lands in the null page only."""
    _, tcfg, _, tp, _, _ = built("yi-9b")
    rng, pool, table = _step_inputs(tcfg)
    B, nblk = table.shape
    w = {"attn": {k: v[0] for k, v in tp["layers"]["attn"].items()},
         "ln1": tp["layers"]["ln1"][0]}
    k_pool = torch.from_numpy(pool[0]).to(torch.bfloat16)
    v_pool = torch.from_numpy(pool[1]).to(torch.bfloat16)
    tab = torch.from_numpy(table).long()
    kstack = teng._pool_view(k_pool, tab)[None].clone()
    vstack = teng._pool_view(v_pool, tab)[None].clone()
    x = torch.from_numpy(rng.randn(B, 1, tcfg.d_model)
                         .astype(np.float32)).to(torch.bfloat16)
    pos = torch.tensor([19, 7], dtype=torch.int32)
    active = torch.tensor([True, False])
    sink = k_pool[0].clone()
    out_p = teng.attn_decode_paged_step(tcfg, w, x, k_pool, v_pool, tab,
                                        pos, active)
    out_s = teng.attn_decode_step(tcfg, w, x, kstack, vstack, 0, pos, active)
    assert torch.equal(out_p, out_s)
    assert torch.equal(teng._pool_view(k_pool, tab), kstack[0])
    assert torch.equal(teng._pool_view(v_pool, tab), vstack[0])
    assert not torch.equal(k_pool[0], sink)      # the inactive row's sink


# ------------------------------------------------------------ allocator
def test_allocator_seeded_ops_driver():
    """A seeded random alloc/free/evict/restore storm with per-op
    invariant checks, then a full drain back to an empty, whole pool."""
    rng = np.random.RandomState(0)
    for n_pages in (2, 3, 5, 9):
        alloc = PageAllocator(n_pages)
        live = []
        for _ in range(400):
            op = rng.randint(0, 8)
            bid = live[rng.randint(0, len(live))] if live else None
            try:
                if op == 0:
                    live.append(alloc.new_block())
                elif bid is None:
                    pass
                elif op == 1:
                    alloc.retain(bid)
                elif op == 2:
                    if alloc.release(bid):
                        live.remove(bid)
                elif op == 3:
                    alloc.touch(bid)
                elif op == 4:
                    alloc.mark_dirty(bid)
                elif op == 5:
                    alloc.pin([bid])
                elif op == 6:
                    alloc.unpin([bid])
                elif op == 7:
                    alloc.ensure_resident([bid])
            except PagePoolFull:
                pass
            alloc.check()
        assert alloc.evictions >= alloc.restores
        for bid in list(live):
            alloc.unpin([bid])
            while bid in alloc.blocks:
                alloc.release(bid)
            alloc.check()
        assert not alloc.blocks and not alloc.by_pid
        assert sorted(alloc.free) == list(range(1, n_pages))


OPS = ("new", "retain", "release", "touch", "dirty", "pin", "unpin",
       "restore")


def _apply(alloc, full_exc, op, bid):
    """One operation; returns what it returned, or the exception's type
    name when it raised the pool-full error."""
    try:
        if op == "new":
            return alloc.new_block()
        if op == "retain":
            return alloc.retain(bid)
        if op == "release":
            return alloc.release(bid)
        if op == "touch":
            return alloc.touch(bid)
        if op == "dirty":
            return alloc.mark_dirty(bid)
        if op == "pin":
            return alloc.pin([bid])
        if op == "unpin":
            return alloc.unpin([bid])
        return alloc.ensure_resident([bid])
    except full_exc:
        return "PagePoolFull"


@settings(max_examples=80, deadline=None)
@given(n_pages=st.integers(min_value=2, max_value=9),
       ops=st.lists(st.tuples(st.sampled_from(OPS),
                              st.integers(min_value=0, max_value=10_000)),
                    max_size=120))
def test_allocator_matches_reference_under_random_ops(n_pages, ops):
    """The port's allocator and the reference's, driven by one random
    operation sequence: equal results (block ids, pages, death), equal
    eviction victims and restores (through the callbacks), equal state,
    and ``check()`` holding after every operation."""
    events = {"port": [], "ref": []}
    port = PageAllocator(n_pages,
                         on_evict=lambda b, p: events["port"].append(
                             ("evict", b, p)),
                         on_restore=lambda b, p: events["port"].append(
                             ("restore", b, p)))
    ref = JPageAllocator(n_pages,
                         on_evict=lambda b, p: events["ref"].append(
                             ("evict", b, p)),
                         on_restore=lambda b, p: events["ref"].append(
                             ("restore", b, p)))
    live = []
    for op, pick in ops:
        bid = live[pick % len(live)] if live else None
        if op != "new" and bid is None:
            continue
        got = _apply(port, PagePoolFull, op, bid)
        want = _apply(ref, JPagePoolFull, op, bid)
        assert got == want, (op, bid)
        if op == "new" and isinstance(got, int):
            live.append(got)
        if op == "release" and got is True:
            live.remove(bid)
        port.check()
        assert events["port"] == events["ref"]
        assert port.free == ref.free and port.by_pid == ref.by_pid
        assert port.pinned == ref.pinned
        assert {b: (x.pid, x.refs, x.dirty, x.has_host, x.last_use)
                for b, x in port.blocks.items()} == \
            {b: (x.pid, x.refs, x.dirty, x.has_host, x.last_use)
             for b, x in ref.blocks.items()}
    assert (port.evictions, port.writebacks, port.restores) == \
        (ref.evictions, ref.writebacks, ref.restores)
