"""The port's serving path end to end against the JAX package, on the CPU.

Both packages open a Session on the same planning inputs (the cli2 client,
its analytic install profile) with the same weights (the JAX package's,
through the numpy param bridge) and serve the same numpy-seeded requests.

- fp32: tokens and streamed bytes equal the reference's at budgets of
  2.0x, 0.5x and 0.1x of the weight bytes;
- bf16: XLA and torch round at other places, so the served tokens are held
  against the reference's monolithic logits under teacher forcing: each
  served token's logit is within ``BF16_GAP`` of that position's maximum;
- inside the port: overlap == sync, fused == per-slot decode and
  layer-major == chunk-major prefill, each bit for bit; a live
  ``update_budget`` mid-serve keeps the tokens and moves exactly
  ``Schedule.diff``;
- quantised FFN weights (``weight_quant`` int8 / int4, through K2 / K3's
  plain versions): in fp32, tokens, ``streamed_bytes`` and
  ``streamed_bytes_by_dtype`` equal the reference's at each budget; the
  in-port equalities above also hold with bf16 int4 weights ("int4").
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
from repro.core import build_graph as jax_graph
from repro.core import run_install as jax_install
from repro.core.executor import PipelinedExecutor as JExecutor
from repro.core.serving import Request as JRequest
from repro.models import build_model as jax_build
from repro_torch import Session
from repro_torch.configs import get_smoke_config as torch_smoke
from repro_torch.core import CLI2, InferenceSetting, run_install
from repro_torch.core.executor import PipelinedExecutor
from repro_torch.core.serving import Request
from repro_torch.models.api import params_from_numpy

torch.set_num_threads(1)

ARCH = "qwen2-0.5b"           # qkv_bias, tied embeddings
BUDGETS = (2.0, 0.5, 0.1)
MAX_SEQ, MAX_BATCH = 48, 2
# the smoke model's bf16 logits reach about 3.6 in magnitude; 2e-2 of 3,
# the kernel tests' bf16 tolerance, is 0.06
BF16_GAP = 0.06


@pytest.fixture(scope="module")
def dbs():
    return jax_install(JCLI2, quick=True), run_install(CLI2, quick=True)


@pytest.fixture(scope="module")
def models():
    out = {}
    for dtype in ("float32", "bfloat16"):
        jcfg = jax_smoke(ARCH).replace(dtype=dtype)
        tcfg = torch_smoke(ARCH).replace(dtype=dtype)
        jp = jax_build(jcfg).init(jax.random.PRNGKey(0))
        tp = params_from_numpy(jax.tree.map(np.asarray, jp))
        total = sum(s.weight_bytes for s in jax_graph(jcfg))
        out[dtype] = (jcfg, tcfg, jp, tp, total)
    for key, mode, dtype in (("int4", "int4", "bfloat16"),
                             ("int8-float32", "int8", "float32"),
                             ("int4-float32", "int4", "float32")):
        jcfg = jax_smoke(ARCH).replace(dtype=dtype, weight_quant=mode)
        tcfg = torch_smoke(ARCH).replace(dtype=dtype, weight_quant=mode)
        jp = jax_build(jcfg).init(jax.random.PRNGKey(0))
        tp = params_from_numpy(jax.tree.map(np.asarray, jp))
        total = sum(s.weight_bytes for s in jax_graph(jcfg))
        out[key] = (jcfg, tcfg, jp, tp, total)
    return out


@pytest.fixture(params=["float32", "bfloat16", "int4"])
def model(models, request):
    return models[request.param]


def _prompts(vocab, n=3):
    rng = np.random.RandomState(0)
    return [rng.randint(0, vocab, size=5 + 7 * i).astype(np.int32)
            for i in range(n)]


def _reqs(cls, vocab, n=3, max_new=6):
    return [cls(rid=i, prompt=p, max_new_tokens=max_new)
            for i, p in enumerate(_prompts(vocab, n))]


def _open(model, dbs, frac, **kw):
    jcfg, tcfg, jp, tp, total = model
    return Session.open(tcfg, CLI2, int(total * frac) + 1,
                        InferenceSetting(batch=MAX_BATCH, context=MAX_SEQ),
                        db=dbs[1], params=tp, max_seq=MAX_SEQ,
                        device="cpu", **kw)


def _serve(sess, fused=True, n=3):
    reqs = _reqs(Request, sess.cfg.vocab, n)
    sess.serve(reqs, max_batch=MAX_BATCH, fused=fused)
    return [r.generated for r in reqs]


def _jax_serve(model, dbs, frac):
    jcfg, _, jp, _, total = model
    s = repro.Session.open(jcfg, JCLI2, int(total * frac) + 1,
                           JSetting(batch=MAX_BATCH, context=MAX_SEQ),
                           db=dbs[0], params=jp, max_seq=MAX_SEQ)
    reqs = _reqs(JRequest, jcfg.vocab)
    s.serve(reqs, max_batch=MAX_BATCH)
    return s, [r.generated for r in reqs]


# ------------------------------------------------------------ vs reference
@pytest.mark.parametrize("frac", BUDGETS)
def test_serve_matches_reference_fp32(models, dbs, frac):
    model = models["float32"]
    sess = _open(model, dbs, frac)
    tokens = _serve(sess)
    st = sess.stats()["serving"]
    if frac == 0.1:
        assert st["streamed_bytes"] > 0
    jsess, jtokens = _jax_serve(model, dbs, frac)
    jst = jsess.stats()["serving"]
    assert tokens == jtokens
    # the ledger follows the plan, which both packages share exactly
    for key in ("streamed_bytes", "tiers_used", "iterations",
                "engine_calls", "generated_tokens"):
        assert st[key] == jst[key], key
    ex = sess.stats()["executor"]
    assert ex["at_use_bytes"] == jsess.executor.stats.at_use_bytes
    assert (ex["at_use_s"] > 0) == (ex["at_use_bytes"] > 0)


def _expected_by_dtype(ex):
    """The ledger split by storage format: every pass streams its tier
    plan's streamed placements that are not pinned."""
    out = {}
    for t in ex.stats.tiers_used:
        for p in ex.schedule.tiers[t].plan.static_stream_order():
            if p.sub.name not in ex._pinned:
                q = p.sub.meta.get("quant", "fp16")
                out[q] = out.get(q, 0) + p.sub.weight_bytes
    return out


@pytest.mark.parametrize("frac", (2.0, 0.25, 0.1))
@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_serve_quantised_matches_reference_fp32(models, dbs, mode, frac):
    """Quantised FFN weights: tokens and the per-dtype streamed-bytes
    ledger equal the reference's; FFN bytes go under the mode, streamed
    attention under "fp16", and the buckets sum to ``streamed_bytes``."""
    model = models[f"{mode}-float32"]
    sess = _open(model, dbs, frac)
    tokens = _serve(sess)
    jsess, jtokens = _jax_serve(model, dbs, frac)
    assert tokens == jtokens
    st, jst = sess.stats()["serving"], jsess.stats()["serving"]
    for key in ("streamed_bytes", "tiers_used", "engine_calls",
                "generated_tokens"):
        assert st[key] == jst[key], key
    ex = sess.stats()["executor"]
    by = ex["streamed_bytes_by_dtype"]
    assert by == dict(jsess.executor.stats.streamed_bytes_by_dtype)
    assert by == _expected_by_dtype(sess.executor)
    assert sum(by.values()) == ex["streamed_bytes"]
    assert set(by) <= {"fp16", mode}
    assert all(s.meta.get("quant", "fp16") ==
               (mode if s.kind == "ffn" else "fp16")
               for s in sess.subs if s.kind in ("attn", "ffn"))
    if frac == 0.1:
        assert by.get(mode, 0) > 0


@pytest.mark.parametrize("frac", [2.0, 0.1])
def test_serve_bf16_teacher_forced_against_reference(models, dbs, frac):
    """XLA and torch round bf16 at other places, so the port's served
    tokens are fed through the reference's monolithic model: each one is
    that position's argmax up to ``BF16_GAP``."""
    jcfg, _, jp, _, _ = model = models["bfloat16"]
    tokens = _serve(_open(model, dbs, frac))
    jm = jax_build(jcfg)
    for prompt, gen in zip(_prompts(jcfg.vocab), tokens):
        seq = np.concatenate([prompt, gen[:-1]]).astype(np.int32)[None]
        logits, _ = jm.apply(jp, {"tokens": jnp.asarray(seq)})
        z = np.asarray(logits[0, len(prompt) - 1:], np.float32)
        gap = z.max(axis=1) - z[np.arange(len(gen)), gen]
        assert gap.max() <= BF16_GAP, (gap, gen)


def test_generate_matches_reference_fp32(models, dbs):
    """Session.generate: layer-major prefill, then the per-step decode
    loop through the chunk pass."""
    jcfg, tcfg, jp, tp, total = model = models["float32"]
    prompts = np.random.RandomState(1).randint(0, jcfg.vocab, (2, 9))
    out = _open(model, dbs, 0.1).generate(prompts, 4)
    js = repro.Session.open(jcfg, JCLI2, int(total * 0.1) + 1,
                            JSetting(batch=MAX_BATCH, context=MAX_SEQ),
                            db=dbs[0], params=jp, max_seq=MAX_SEQ)
    assert out.shape == (2, 4)
    assert np.array_equal(out, np.asarray(js.generate(prompts, 4)))


@pytest.mark.parametrize("dtype,max_seq", [("float32", 24), ("float32", 32),
                                           ("bfloat16", 24)])
def test_layer_major_tail_near_max_seq_matches_reference(models, dbs, dtype,
                                                         max_seq):
    """A 21-token prompt in 16-token chunks: padding the tail to 32 would
    run the cache write past max_seq=24, where dynamic_update_slice clamps
    the start over valid positions. Both packages then run the tail at its
    natural length (24) or pad it (32), with the same cache and logits."""
    jcfg, tcfg, jp, tp, total = model = models[dtype]
    tok = np.random.RandomState(2).randint(0, jcfg.vocab, (1, 21)) \
        .astype(np.int32)
    sched = _open(model, dbs, 0.1).schedule
    tex = PipelinedExecutor(tcfg, tp, sched, max_seq=max_seq, device="cpu")
    kv = tex.init_kv(1)
    tl, _ = tex._prefill_layer_major(torch.from_numpy(tok), kv, 16, 16)
    jsched = repro.Session.open(
        jcfg, JCLI2, int(total * 0.1) + 1,
        JSetting(batch=MAX_BATCH, context=MAX_SEQ), db=dbs[0],
        params=jp).schedule
    jex = JExecutor(jcfg, jp, jsched, max_seq=max_seq)
    jl, jkv, _ = jex._prefill_layer_major(jnp.asarray(tok), jex.init_kv(1),
                                          16, 16)
    tol = dict(rtol=2e-5, atol=2e-5) if jcfg.dtype == "float32" \
        else dict(rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(tl.to(torch.float32).numpy(),
                               np.asarray(jl, np.float32), **tol)
    np.testing.assert_allclose(kv["k"].to(torch.float32).numpy(),
                               np.asarray(jkv["k"], np.float32),
                               rtol=2e-2, atol=2e-2)
    assert not kv["k"][:, :, :, 21:].any()     # nothing past the prompt


# ------------------------------------------------------------ inside the port
def test_overlap_equals_sync(model, dbs):
    a = _serve(_open(model, dbs, 0.1, overlap=True))
    b = _serve(_open(model, dbs, 0.1, overlap=False))
    assert a == b


def test_fused_equals_per_slot(model, dbs):
    fused = _open(model, dbs, 0.1)
    per_slot = _open(model, dbs, 0.1)
    assert _serve(fused) == _serve(per_slot, fused=False)


def test_layer_major_equals_chunk_major(model, dbs):
    lm = _serve(_open(model, dbs, 0.1, prefill_mode="layer_major"))
    cm = _serve(_open(model, dbs, 0.1, prefill_mode="chunk_major"))
    assert lm == cm


def test_tokens_identical_across_budgets(model, dbs):
    runs = [_serve(_open(model, dbs, f)) for f in BUDGETS]
    assert runs[0] == runs[1] == runs[2]


def test_update_budget_mid_serve(model, dbs):
    jcfg, _, jp, _, total = model
    live = _open(model, dbs, 2.0)
    reqs = _reqs(Request, jcfg.vocab)
    live.serve(reqs, max_batch=MAX_BATCH, max_iterations=2)
    assert any(sl is not None for sl in live.batcher().slots)
    pinned_before = dict(live.executor._pinned)
    diff = live.update_budget(int(total * 0.1) + 1)
    assert diff.to_evict
    ex = live.executor.stats
    assert (ex.rebinds, ex.rebind_pinned_bytes, ex.rebind_evicted_bytes) \
        == (1, diff.pin_bytes, diff.evict_bytes)
    for name in set(pinned_before) - set(diff.to_evict):
        assert live.executor._pinned[name] is pinned_before[name]
    live.serve([])
    assert [r.generated for r in reqs] == _serve(_open(model, dbs, 0.1))
    # the same delta as the reference's Schedule.diff
    js = repro.Session.open(jcfg, JCLI2, int(total * 2.0) + 1,
                            JSetting(batch=MAX_BATCH, context=MAX_SEQ),
                            db=dbs[0], params=jp, max_seq=MAX_SEQ)
    jdiff = js.update_budget(int(total * 0.1) + 1)
    assert (diff.to_pin, diff.to_evict, diff.pin_bytes, diff.evict_bytes) \
        == (jdiff.to_pin, jdiff.to_evict, jdiff.pin_bytes, jdiff.evict_bytes)


def test_update_setting_replans_like_reference(models, dbs):
    jcfg, _, jp, _, total = model = models["float32"]
    s = _open(model, dbs, 0.5)
    diff = s.update_setting(context=32, batch=1)
    assert (s.setting.context, s.setting.batch) == (32, 1)
    assert s.replan_log == [diff]
    js = repro.Session.open(jcfg, JCLI2, int(total * 0.5) + 1,
                            JSetting(batch=MAX_BATCH, context=MAX_SEQ),
                            db=dbs[0], params=jp, max_seq=MAX_SEQ)
    jdiff = js.update_setting(context=32, batch=1)
    assert (diff.to_pin, diff.to_evict, diff.pin_bytes, diff.evict_bytes) \
        == (jdiff.to_pin, jdiff.to_evict, jdiff.pin_bytes, jdiff.evict_bytes)
    assert s.estimates(16) == {k: v for k, v in js.estimates(16).items()
                               if k in s.estimates(16)}


def test_cancel_leaves_other_requests_untouched(model, dbs):
    vocab = model[0].vocab
    ref = _serve(_open(model, dbs, 0.1))
    sess = _open(model, dbs, 0.1)
    reqs = _reqs(Request, vocab)
    sess.serve(reqs, max_batch=MAX_BATCH, max_iterations=2)
    b = sess.batcher()
    assert b.cancel(2) == "queued"          # found no free slot yet
    assert b.cancel(0) == "active"
    assert b.cancel(0) is None and b.cancel(99) is None
    sess.serve([])
    assert reqs[1].generated == ref[1]
    assert ref[0][:len(reqs[0].generated)] == reqs[0].generated
    assert reqs[2].generated == []
    assert b.stats()["cancelled"] == 2


# ------------------------------------------------------------ device rule
def test_open_without_cuda_raises(model, dbs, monkeypatch):
    """No CUDA and no device="cpu": the session raises, it does not carry
    on on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    jcfg, tcfg, jp, tp, total = model
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Session.open(tcfg, CLI2, total, db=dbs[1], params=tp)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PipelinedExecutor(tcfg, tp, _open(model, dbs, 2.0).schedule)


@pytest.mark.parametrize("option,kw,error,match", [
    # expert-granular MoE is ported: on a dense model the option raises
    # the reference's conflict error instead
    ("expert_granular", dict(expert_granular=True), ValueError,
     "requires an MoE config"),
    # paged KV and speculative decoding are ported: their options raise
    # the reference's validation errors instead
    ("paged", dict(kv_layout="ring"), ValueError, "kv_layout"),
    ("speculative", dict(spec_k=2), ValueError, "draft"),
    # fault injection is ported: a plan that is not a FaultPlan raises
    ("fault", dict(faults=object()), TypeError, "FaultPlan"),
])
def test_unported_options_name_their_slice(model, dbs, option, kw, error,
                                           match):
    with pytest.raises(error, match=match):
        _open(model, dbs, 2.0, **kw)
    # the gateway is ported: it fronts the session's own batcher
    sess = _open(model, dbs, 2.0)
    gw = sess.gateway(max_batch=2)
    assert gw.session is sess and gw.batcher is sess.batcher()


@pytest.mark.parametrize("arch", ["musicgen-medium", "zamba2-7b"])
def test_unported_families_name_their_slice(dbs, arch):
    """Audio and hybrid models are later slices of the port."""
    with pytest.raises(NotImplementedError, match="slice"):
        Session.open(torch_smoke(arch), CLI2, 1 << 30, db=dbs[1],
                     device="cpu")


def test_vlm_session_is_planning_only(dbs):
    """A vlm session plans (graph, schedule, estimates) and raises on
    execution, naming the executor, as the reference asserts."""
    sess = Session.open(torch_smoke("qwen2-vl-7b"), CLI2, 1 << 20,
                        InferenceSetting(batch=1, context=MAX_SEQ),
                        db=dbs[1], max_seq=MAX_SEQ, device="cpu")
    assert sess.estimates()["pinned_bytes"] > 0
    for use in (lambda: sess.executor, lambda: sess.batcher(),
                lambda: sess.serve([]),
                lambda: sess.generate(np.zeros((1, 4), np.int32))):
        with pytest.raises(NotImplementedError, match="executor"):
            use()
