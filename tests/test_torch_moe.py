"""The port's MoE against the JAX package, on the CPU (smoke qwen30b-a3b:
d=64, 8 experts, top-2, d_expert=96; the JAX package's weights through the
numpy param bridge, numpy-seeded inputs).

Against the reference:
- ``moe_dispatch`` and ``moe_combine`` bit-equal on identical inputs, bf16
  and f32, dropless and truncating, router ties included; ``_route``'s
  indices equal (ties to the lower index) with gates within f32 rounding;
- ``moe_ffn`` within 2e-2 of the output's scale in bf16 and 2e-5 in f32,
  with and without ``valid``, dropless and truncating;
- stacked int8 / int4 expert trees and ``expert_quant`` trees byte-equal;
- served tokens equal, with ``expert_demanded``, ``expert_hits``,
  ``demanded_expert_bytes``, ``streamed_bytes`` and the routing EMA equal
  to the reference's, granular and monolithic, at several budgets;
- the conflict errors, and hot experts pinned from routing stats and from
  the EMA.

Inside the port, bit for bit: granular == monolithic at budgets 0.2, 0.6
and 2.0; overlap == sync; fused == per-slot; layer-major == chunk-major;
the ``update_budget`` expert swap; the phased engine steps == ``moe_step``.
Also the demand pool of the prefetcher, the ledger ``streamed == static
plan + demanded`` and the per-step demand bound.
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
from repro.models import mlp as jmlp
from repro.models.common import NoPolicy
from repro_torch import Session
from repro_torch.configs import get_smoke_config as torch_smoke
from repro_torch.core import (CLI2, InferenceSetting, TimingEstimator,
                              build_graph, build_schedule, run_install)
from repro_torch.core import engine as teng
from repro_torch.core.executor import PipelinedExecutor
from repro_torch.core.graphing import expert_weight_bytes
from repro_torch.core.prefetch import PrefetchEngine
from repro_torch.core.serving import Request
from repro_torch.models import build_model as torch_build
from repro_torch.models import mlp as tmlp
from repro_torch.models.api import params_from_numpy, tensor_from_numpy
from repro_torch.models.common import tree_leaves
from repro_torch.models.transformer import quantize_params

torch.set_num_threads(1)

ARCH = "qwen30b-a3b"
MAX_SEQ, MAX_BATCH = 48, 2
DT = {"float32": (jnp.float32, torch.float32),
      "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy() if x.is_floating_point() \
            else x.numpy()
    return np.asarray(x.astype(jnp.float32) if jnp.issubdtype(
        x.dtype, jnp.floating) else x)


def _bytes(a):
    """The raw bytes of an array or tensor, for byte-equality."""
    if isinstance(a, torch.Tensor):
        a = a.contiguous()
        if a.dtype == torch.bfloat16:
            a = a.view(torch.int16)
        return a.numpy().tobytes()
    return np.asarray(a).tobytes()


@pytest.fixture(scope="module")
def dbs():
    return jax_install(JCLI2, quick=True), run_install(CLI2, quick=True)


@pytest.fixture(scope="module")
def models():
    """dtype -> (jax cfg, port cfg, jax params, port params, granular
    weight bytes)."""
    out = {}
    for name, kw in (("float32", dict(dtype="float32")),
                     ("bfloat16", dict(dtype="bfloat16")),
                     ("int8-experts", dict(dtype="float32",
                                           expert_quant="int8")),
                     ("int4", dict(dtype="float32", weight_quant="int4"))):
        jcfg = jax_smoke(ARCH).replace(**kw)
        tcfg = torch_smoke(ARCH).replace(**kw)
        jp = jax_build(jcfg).init(jax.random.PRNGKey(0))
        tp = params_from_numpy(jax.tree.map(np.asarray, jp))
        total = sum(s.weight_bytes for s in
                    jax_graph(jcfg, wdtype=2, expert_granular=True))
        out[name] = (jcfg, tcfg, jp, tp, total)
    return out


@pytest.fixture(params=["float32", "bfloat16"])
def model(models, request):
    return models[request.param]


def _moe_params(dtype, router=None):
    """One layer's MoE tree from the reference's init, and the bridge."""
    jcfg = jax_smoke(ARCH).replace(dtype=dtype)
    jp = jmlp.init_moe_params(jax.random.PRNGKey(3), jcfg, DT[dtype][0])
    if router is not None:
        jp = {**jp, "router": jnp.asarray(router)}
    return jcfg, jp, params_from_numpy(jax.tree.map(np.asarray, jp))


def _tied_router(kind, d, E):
    """A router whose columns tie on purpose: every column equal (all
    probabilities tie), or columns 1, 3 and 5 equal to column 0."""
    r = np.random.RandomState(7).standard_normal((d, E)).astype(np.float32)
    if kind == "all":
        r[:] = r[:, :1]
    elif kind == "pairs":
        r[:, 1] = r[:, 3] = r[:, 5] = r[:, 0]
    return r


def _x(T, d, dtype, seed=1):
    x = np.random.RandomState(seed).standard_normal((T, d)) \
        .astype(np.float32)
    jx = jnp.asarray(x, DT[dtype][0])
    return jx, tensor_from_numpy(np.asarray(jx))


# ------------------------------------------------------------ routing math
@pytest.mark.parametrize("ties", [None, "pairs", "all"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_route_indices_equal_ties_included(dtype, ties):
    jcfg, jp, tp = _moe_params(dtype, router=None if ties is None else
                               _tied_router(ties, 64, 8))
    jx, tx = _x(37, 64, dtype)
    jg, ji, jprobs = jmlp._route(jx, jp["router"], jcfg.moe)
    tg, ti, tprobs = tmlp._route(tx, tp["router"], jcfg.moe)
    assert np.array_equal(np.asarray(ji), ti.numpy())
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(tprobs.numpy(), np.asarray(jprobs),
                               rtol=1e-6, atol=1e-6)
    if ties == "all":        # every probability ties: the lowest ids win
        assert (ti.numpy() == np.arange(jcfg.moe.top_k)).all()


@pytest.mark.parametrize("capacity", [None, 3])
@pytest.mark.parametrize("ties", [None, "pairs"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dispatch_and_combine_bit_equal(dtype, ties, capacity):
    """Identical inputs (the reference's gates and ids) give bit-equal
    dispatch buffers, coordinates and combines; ``capacity=3`` truncates
    (drops assignments), None is the dropless capacity."""
    jcfg, jp, tp = _moe_params(dtype, router=None if ties is None else
                               _tied_router(ties, 64, 8))
    m = jcfg.moe
    T = 37
    jx, tx = _x(T, 64, dtype)
    jg, ji, _ = jmlp._route(jx, jp["router"], m)
    cap = capacity or jmlp.capacity_of(T, m)
    jdisp, jaux = jmlp.moe_dispatch(jx, jg, ji, m, m.n_experts, 0, cap)
    tg = torch.from_numpy(np.array(jg))
    ti = torch.from_numpy(np.array(ji)).to(torch.int64)
    tdisp, taux = tmlp.moe_dispatch(tx, tg, ti, m, m.n_experts, 0, cap)
    assert _bytes(tdisp) == _bytes(jdisp)
    for a, b in zip(jaux, taux):
        assert np.array_equal(np.asarray(a), b.numpy())
    if capacity:
        assert not taux[2].all(), "fixture: nothing was dropped"
    # the combine of one expert output buffer, made from a seed
    out = np.random.RandomState(5).standard_normal(jdisp.shape) \
        .astype(np.float32)
    jout = jnp.asarray(out, DT[dtype][0])
    jc = jmlp.moe_combine(jout, jaux, T, DT[dtype][0])
    tc = tmlp.moe_combine(tensor_from_numpy(np.asarray(jout)), taux, T,
                          DT[dtype][1])
    assert _bytes(tc) == _bytes(jc)


def test_combine_rounds_after_every_add_in_k_order():
    """top-8 in bf16: the k-ordered sum with a rounding per add is the
    reference's scatter-add; one f32 sum over k would differ."""
    m = jax_smoke(ARCH).moe.__class__(n_experts=16, top_k=8, d_expert=8)
    T, d = 29, 32
    rng = np.random.RandomState(4)
    jx = jnp.asarray(rng.standard_normal((T, d)), jnp.bfloat16)
    router = jnp.asarray(rng.standard_normal((d, 16)), jnp.float32)
    jg, ji, _ = jmlp._route(jx, router, m)
    jdisp, jaux = jmlp.moe_dispatch(jx, jg, ji, m, 16, 0, T)
    out = jnp.asarray(rng.standard_normal(jdisp.shape), jnp.bfloat16)
    ref = jmlp.moe_combine(out, jaux, T, jnp.bfloat16)
    taux = tuple(torch.from_numpy(np.array(a)) for a in jaux)
    taux = (taux[0].long(), taux[1].long()) + taux[2:]
    tout = tensor_from_numpy(np.asarray(out))
    assert _bytes(tmlp.moe_combine(tout, taux, T, torch.bfloat16)) \
        == _bytes(ref)
    g = tout[taux[0], taux[1]] * (taux[3] * taux[2].float()) \
        .to(torch.bfloat16)[:, None]
    once = g.reshape(T, 8, d).float().sum(1).to(torch.bfloat16)
    assert _bytes(once) != _bytes(ref)


@pytest.mark.parametrize("regime", ["dropless", "truncating"])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_ffn_matches_reference(dtype, masked, regime, monkeypatch):
    if regime == "truncating":
        monkeypatch.setattr(jmlp, "DROPLESS_MAX_ASSIGN", 8)
        monkeypatch.setattr(tmlp, "DROPLESS_MAX_ASSIGN", 8)
    jcfg, jp, tp = _moe_params(dtype)
    tcfg = torch_smoke(ARCH).replace(dtype=dtype)
    x = np.random.RandomState(2).standard_normal((2, 13, 64)) \
        .astype(np.float32)
    jx = jnp.asarray(x, DT[dtype][0])
    tx = tensor_from_numpy(np.asarray(jx))
    valid = np.arange(13)[None, :] < np.array([[13], [9]]) if masked \
        else None
    ref = jmlp.moe_ffn(jp, jcfg, jx, NoPolicy(),
                       valid=None if valid is None else jnp.asarray(valid))
    out = tmlp.moe_ffn(tp, tcfg, tx, valid=None if valid is None
                       else torch.from_numpy(valid))
    assert out.dtype == DT[dtype][1] and tuple(out.shape) == (2, 13, 64)
    err = np.abs(_np(out) - _np(ref)).max()
    scale = np.abs(_np(ref)).max()
    assert err <= (2e-2 if dtype == "bfloat16" else 2e-5) * scale, err
    if masked:    # padded positions get exactly nothing
        assert not _np(out)[1, 9:].any()
    # the split tree (as the executor moves it) gives the same bits
    split = tmlp.moe_ffn(tmlp.split_experts(tp), tcfg, tx,
                         valid=None if valid is None
                         else torch.from_numpy(valid))
    assert torch.equal(split, out)


# ------------------------------------------------------------ quantised
@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_stacked_expert_quantisation_byte_equal(mode):
    """``weight_quant`` on the stacked (E, K, N) experts: the reference
    vmaps its quantiser, the port loops over experts; codes, scales and
    zero-points are byte-equal."""
    jcfg = jax_smoke(ARCH)
    jp = jmlp.init_moe_params(jax.random.PRNGKey(3), jcfg, jnp.bfloat16)
    jq = jmlp.init_moe_params(jax.random.PRNGKey(3),
                              jcfg.replace(weight_quant=mode), jnp.bfloat16)
    tq = tmlp.quantize_weight_tree(
        params_from_numpy(jax.tree.map(np.asarray, jp)), mode)
    assert sorted(tq) == sorted(jq)
    for k in jq:
        assert tuple(tq[k].shape) == jq[k].shape, k
        assert _bytes(tq[k]) == _bytes(jq[k]), k


def test_expert_quant_int8_byte_equal():
    """``expert_quant="int8"``: one (E, 1, 1) f32 scale per expert."""
    jcfg = jax_smoke(ARCH)
    jp = jmlp.init_moe_params(jax.random.PRNGKey(3), jcfg, jnp.bfloat16)
    jq = jmlp.init_moe_params(jax.random.PRNGKey(3),
                              jcfg.replace(expert_quant="int8"),
                              jnp.bfloat16)
    tq = tmlp.quantize_experts_int8(
        params_from_numpy(jax.tree.map(np.asarray, jp)))
    assert sorted(tq) == sorted(jq)
    assert tuple(tq["s_gate"].shape) == (8, 1, 1)
    for k in jq:
        assert _bytes(tq[k]) == _bytes(jq[k]), k


@pytest.mark.parametrize("name,kw", [
    ("int8-experts", dict(expert_quant="int8")),
    ("int4", dict(weight_quant="int4")),
    ("int8", dict(weight_quant="int8")),
])
def test_quantised_model_trees_bridge_and_requantise(models, name, kw):
    """The bridge carries the reference's quantised MoE tree bit for bit,
    and ``quantize_params`` on the float tree gives the same bytes."""
    jcfg = jax_smoke(ARCH).replace(dtype="float32", **kw)
    jq = jax_build(jcfg).init(jax.random.PRNGKey(0))
    tq = params_from_numpy(jax.tree.map(np.asarray, jq))
    mine = quantize_params(models["float32"][3],
                           kw.get("weight_quant", "fp16"),
                           kw.get("expert_quant", "none"))
    jl, tl, ml = (_by_path(jax.tree.map(np.asarray, jq)), _by_path(tq),
                  _by_path(mine))
    assert sorted(jl) == sorted(tl) == sorted(ml)
    for path, a in jl.items():
        assert _bytes(tl[path]) == _bytes(a) == _bytes(ml[path]), path


def _by_path(tree, prefix=""):
    """A nested dict's leaves by their key path."""
    if isinstance(tree, dict):
        return {p: v for k, sub in tree.items()
                for p, v in _by_path(sub, f"{prefix}/{k}").items()}
    return {prefix: tree}


def test_expert_ffn_takes_the_kernels_and_no_dequant(monkeypatch):
    """Every expert matmul goes through ``_mm_dispatch``; a per-expert
    int8 expert is one K2 group (its scale broadcast to (1, 1, N)); no
    weight is dequantised outside the kernels' plain versions."""
    calls = []
    real = tmlp.streamed_matmul_int8

    def spy(x, w, s):
        calls.append(tuple(s.shape))
        return real(x, w, s)
    monkeypatch.setattr(tmlp, "streamed_matmul_int8", spy)
    monkeypatch.setattr(tmlp, "_dequant", None)
    jcfg = jax_smoke(ARCH).replace(expert_quant="int8", dtype="float32")
    jp = jmlp.init_moe_params(jax.random.PRNGKey(3), jcfg, jnp.float32)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp))
    jx, tx = _x(6, 64, "float32")
    out = tmlp.expert_ffn(tmlp.expert_tree(tp, 2), tx)
    assert calls == [(1, 1, 96), (1, 1, 96), (1, 1, 64)]
    ref = jmlp._expert_compute(jnp.broadcast_to(jx, (8, 6, 64)), jp, jcfg)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref[2]), rtol=2e-5,
                               atol=2e-5)


# ------------------------------------------------------------ engine
@pytest.mark.parametrize("valid_len", [None, 9])
def test_phased_steps_equal_moe_step(model, valid_len):
    """route -> experts (pinned group, then one expert at a time) ->
    combine == the monolithic step, bit for bit."""
    jcfg, tcfg, _, tp, _ = model
    lp = {"moe": {k: v[0] for k, v in tp["layers"]["moe"].items()},
          "ln2": tp["layers"]["ln2"][0]}
    x = tensor_from_numpy(np.asarray(jnp.asarray(
        np.random.RandomState(3).standard_normal((2, 12, 64)),
        DT[jcfg.dtype][0])))
    if valid_len is None:
        mono = teng.moe_step(tcfg, lp, x)
        disp, aux, idx = teng.moe_route_step(
            tcfg, {"router": lp["moe"]["router"], "ln2": lp["ln2"]}, x)
    else:
        mono = teng.moe_prefill_step(tcfg, lp, x, valid_len)
        disp, aux, idx = teng.moe_route_prefill_step(
            tcfg, {"router": lp["moe"]["router"], "ln2": lp["ln2"]}, x,
            valid_len)
        assert (idx.reshape(2, 12, -1)[:, valid_len:] == 8).all()
    ids = tmlp.routed_experts(idx, 8)
    out_buf = torch.zeros_like(disp)
    teng.moe_experts_step([(e, tmlp.expert_tree(lp["moe"], e))
                           for e in ids[::2]], disp, out_buf)
    for e in ids[1::2]:
        teng.moe_experts_step([(e, tmlp.expert_tree(lp["moe"], e))],
                              disp, out_buf)
    assert torch.equal(teng.moe_combine_step(x, out_buf, aux), mono)


# ------------------------------------------------------------ prefetch
class _Sub:
    def __init__(self, name, nbytes=4):
        self.name, self.weight_bytes = name, nbytes


class _Pl:
    def __init__(self, name):
        self.sub = _Sub(name)


@pytest.mark.parametrize("avail,slots", [(None, 2), (16, 2), (10, 1)])
def test_demand_pool_slots_and_order(avail, slots):
    """Demanded shards stage on their own pool (1 or 2 slots from what
    the static slots leave), in request order: as many as there are free
    slots on ``request``, then one on each ``release``; ``discard`` and
    ``abandon`` free a slot, once."""
    staged = []

    def fetch(sub):
        staged.append(sub.name)
        return [{"w": torch.full((2,), float(len(staged)))}]
    pf = PrefetchEngine(fetch, torch.device("cpu"))
    pf.start([_Pl("s0")], avail_bytes=avail, demand_bytes=4)
    assert pf.stats.demand_slots == slots
    assert pf.acquire("s0")[0]["w"].shape == (2,)
    pf.release("s0")
    pf.request([_Pl("e1"), _Pl("e2"), _Pl("e3"), _Pl("e4"), _Pl("e5")])
    assert staged == ["s0", "e1", "e2"][:1 + slots]
    for name in ("e1", "e2"):
        pf.acquire(name)
        pf.release(name)
    assert staged == ["s0", "e1", "e2", "e3", "e4"][:3 + slots]
    pf.acquire("e3")
    pf.discard("e3")
    pf.abandon("e4")
    pf.abandon("e5")
    pf.finish()
    assert not pf.active
    assert staged == ["s0", "e1", "e2", "e3", "e4", "e5"]
    assert pf.stats.demanded_sublayers == 5
    assert pf.stats.staged_sublayers == 6


def test_demand_entries_acquired_out_of_turn_raise():
    """One demand slot: the second entry is copied only once the first is
    released, so acquiring it before that is a consumer fault, raised and
    not waited on; ``finish`` drops an entry never copied."""
    pf = PrefetchEngine(lambda sub: [{"w": torch.zeros(1)}],
                        torch.device("cpu"))
    pf.start([], avail_bytes=0, demand_bytes=4)
    assert pf.stats.demand_slots == 1
    pf.request([_Pl("e0"), _Pl("e1")])
    pf.acquire("e0")
    with pytest.raises(AssertionError, match="before a demand slot freed"):
        pf.acquire("e1")
    pf.finish()
    assert not pf.active and pf.stats.demanded_sublayers == 1


def test_pack_places_leaves_in_one_aligned_allocation():
    """What ``groups_to_device`` does per group of leaves on the card, here
    on the CPU: one buffer, each view 256-byte aligned, the same bits."""
    from repro_torch.core.prefetch import _pack
    g = torch.Generator().manual_seed(6)
    leaves = [torch.randn(3, 5, generator=g),
              torch.randint(-127, 127, (7, 3), dtype=torch.int8,
                            generator=g),
              torch.full((1, 1), 0.25),
              torch.randn(4, generator=g).to(torch.bfloat16)]
    out = _pack(leaves, torch.device("cpu"), False)
    base = out[0].untyped_storage().data_ptr()
    for a, b in zip(out, leaves):
        assert torch.equal(a, b) and a.dtype == b.dtype
        assert a.untyped_storage().data_ptr() == base
        assert (a.data_ptr() - base) % 256 == 0
    assert _pack([], torch.device("cpu"), False) == []


def test_request_without_demand_pool_raises():
    pf = PrefetchEngine(lambda sub: [{}], torch.device("cpu"))
    pf.start([_Pl("s0")])
    with pytest.raises(AssertionError, match="demand pool"):
        pf.request([_Pl("e0")])
    pf.finish()


# ------------------------------------------------------------ executor
def _reqs(cls, vocab, n=3, max_new=5):
    rng = np.random.RandomState(0)
    return [cls(rid=i, prompt=rng.randint(0, vocab, size=6 + 5 * i)
                .astype(np.int32), max_new_tokens=max_new)
            for i in range(n)]


def _open(model, dbs, frac, **kw):
    jcfg, tcfg, jp, tp, total = model
    return Session.open(tcfg, CLI2, int(total * frac) + 1,
                        InferenceSetting(batch=MAX_BATCH, context=MAX_SEQ),
                        db=dbs[1], params=tp, max_seq=MAX_SEQ, device="cpu",
                        **kw)


def _serve(sess, fused=True):
    reqs = _reqs(Request, sess.cfg.vocab)
    sess.serve(reqs, max_batch=MAX_BATCH, fused=fused)
    return [r.generated for r in reqs]


def _jax_serve(model, dbs, frac, **kw):
    jcfg, _, jp, _, total = model
    s = repro.Session.open(jcfg, JCLI2, int(total * frac) + 1,
                           JSetting(batch=MAX_BATCH, context=MAX_SEQ),
                           db=dbs[0], params=jp, max_seq=MAX_SEQ, **kw)
    reqs = _reqs(JRequest, jcfg.vocab)
    s.serve(reqs, max_batch=MAX_BATCH)
    return s, [r.generated for r in reqs]


COUNTERS = ("expert_demanded", "expert_hits", "demanded_expert_bytes",
            "streamed_bytes", "resident_expert_bytes")


@pytest.mark.parametrize("granular", [True, False])
@pytest.mark.parametrize("frac", [0.2, 0.6, 2.0])
@pytest.mark.parametrize("name", ["float32", "bfloat16", "int8-experts",
                                  "int4"])
def test_serve_matches_reference(models, dbs, name, frac, granular):
    """Tokens and the expert counters equal the reference's; the ledger
    streamed == static plan + demanded expert bytes, by dtype too."""
    model = models[name]
    sess = _open(model, dbs, frac, expert_granular=granular)
    tokens = _serve(sess)
    jsess, jtokens = _jax_serve(model, dbs, frac, expert_granular=granular)
    assert tokens == jtokens
    ex, jex = sess.executor, jsess.executor
    for key in COUNTERS:
        assert getattr(ex.stats, key) == getattr(jex.stats, key), key
    assert dict(ex.stats.streamed_bytes_by_dtype) == \
        dict(jex.stats.streamed_bytes_by_dtype)
    assert sess.stats()["serving"]["engine_calls"] == \
        jsess.stats()["serving"]["engine_calls"]
    static = sum(p.sub.weight_bytes for t in ex.stats.tiers_used
                 for p in ex.schedule.tiers[t].plan.static_stream_order()
                 if p.sub.name not in ex._pinned)
    assert ex.stats.streamed_bytes == \
        static + ex.stats.demanded_expert_bytes
    if granular:
        assert sorted(ex.expert_ema) == sorted(jex.expert_ema)
        for layer, freqs in ex.expert_ema.items():
            assert np.array_equal(freqs, jex.expert_ema[layer])
        if frac == 0.2:
            assert ex.stats.demanded_expert_bytes > 0
            assert ex.prefetch.stats.demanded_sublayers > 0
        # the pool carries part of the demanded bytes, never more
        shard = max(s.weight_bytes for s in sess.subs
                    if s.kind == "moe_expert")
        assert ex.prefetch.stats.demanded_sublayers * shard <= \
            ex.stats.demanded_expert_bytes
    else:
        assert ex.stats.expert_demanded == 0


def test_moe_sublayer_moves_as_one_group_per_expert(models, dbs):
    """A whole MoE sub-layer reaches the prefetcher as its router and
    norm, then one tree per expert (one allocation each on the card);
    ``_join`` gives back the tree ``moe_step`` takes, the same bits as
    the layer's stacked tree."""
    from repro_torch.core.prefetch import groups_to_device
    sess = _open(models["bfloat16"], dbs, 0.6, expert_granular=False)
    ex, cfg = sess.executor, sess.cfg
    sub = next(s for s in sess.subs if s.kind == "moe")
    groups = ex._subtree(sub)
    E = cfg.moe.n_experts
    assert len(groups) == 1 + E and set(groups[0]) == {"router", "ln2"}
    w = ex._join(groups_to_device(groups, torch.device("cpu")))
    lp = ex.layer_params[sub.layer]
    assert sorted(w["moe"]["experts"]) == list(range(E))
    for e in range(E):
        want = tmlp.expert_tree(lp["moe"], e)
        got = w["moe"]["experts"][e]
        assert sorted(got) == sorted(want)
        assert all(torch.equal(got[k], want[k]) for k in want)
    x = torch.from_numpy(np.random.default_rng(8).standard_normal(
        (2, 3, cfg.d_model)).astype(np.float32)).to(torch.bfloat16)
    assert torch.equal(teng.moe_step(cfg, w, x), teng.moe_step(
        cfg, {"moe": lp["moe"], "ln2": lp["ln2"]}, x))


def test_one_demand_slot_serves_what_two_serve(models, dbs):
    """With one demand slot, every streamed cold expert still goes through
    the pool, each copied once the one before it is released: the tokens
    and the expert counters of two slots."""
    model = models["bfloat16"]
    two = _open(model, dbs, 0.6, expert_granular=True)
    want = _serve(two)
    sess = _open(model, dbs, 0.6, expert_granular=True)
    pf = sess.executor.prefetch
    start = pf.start
    # no scratch to spare: one static and one demand slot
    pf.start = lambda order, avail_bytes=None, demand_bytes=0: start(
        order, avail_bytes=0, demand_bytes=demand_bytes)
    assert _serve(sess) == want
    assert two.executor.prefetch.stats.demand_slots == 2
    assert pf.stats.demand_slots == 1
    for key in COUNTERS:
        assert getattr(sess.executor.stats, key) == \
            getattr(two.executor.stats, key), key
    assert pf.stats.demanded_sublayers == \
        two.executor.prefetch.stats.demanded_sublayers > 0


@pytest.mark.parametrize("frac", [0.2, 0.6, 2.0])
def test_granular_bit_identical_to_monolithic(model, dbs, frac):
    gran = _open(model, dbs, frac, expert_granular=True)
    mono = _open(model, dbs, frac, expert_granular=False)
    assert gran.schedule.expert_granular and not mono.schedule \
        .expert_granular
    assert _serve(gran) == _serve(mono)


def test_overlap_equals_sync(model, dbs):
    a = _open(model, dbs, 0.2, overlap=True)
    b = _open(model, dbs, 0.2, overlap=False)
    assert _serve(a) == _serve(b)
    assert a.executor.stats.streamed_bytes == b.executor.stats.streamed_bytes
    assert a.executor.stats.demanded_expert_bytes == \
        b.executor.stats.demanded_expert_bytes > 0


def test_fused_equals_per_slot(model, dbs):
    assert _serve(_open(model, dbs, 0.2)) == \
        _serve(_open(model, dbs, 0.2), fused=False)


def _schedule(tcfg, dbs, frac, granular, tiers=(8,)):
    subs = build_graph(tcfg, wdtype=2, expert_granular=granular)
    budget = int(sum(s.weight_bytes for s in subs) * frac) + 1
    return build_schedule(budget, subs, TimingEstimator(dbs[1], CLI2),
                          InferenceSetting(batch=2, context=64), tiers=tiers)


@pytest.mark.parametrize("regime", ["dropless", "truncating"])
@pytest.mark.parametrize("granular", [True, False])
def test_layer_major_equals_chunk_major(model, dbs, granular, regime,
                                        monkeypatch):
    """A 13-token prompt in 4-token chunks (a padded 1-token tail): logits,
    KV and decoded tokens equal chunk-major bit for bit. In the truncating
    regime the tail runs unpadded."""
    if regime == "truncating":
        monkeypatch.setattr(tmlp, "DROPLESS_MAX_ASSIGN", 8)
    jcfg, tcfg, _, tp, _ = model
    sched = _schedule(tcfg, dbs, 0.2, granular)
    tokens = torch.from_numpy(np.random.RandomState(4).randint(
        0, tcfg.vocab, (2, 13)).astype(np.int32))
    out = []
    for mode in ("layer_major", "chunk_major"):
        ex = PipelinedExecutor(tcfg, tp, sched, max_seq=64,
                               prefill_mode=mode, device="cpu")
        last, kv, pos = ex.prefill(tokens)
        gen, _ = ex.decode(torch.argmax(last, -1).to(torch.int32), kv, pos,
                           steps=4)
        out.append((last, kv, gen, ex.stats.prefill_stats[0]))
    (l1, kv1, g1, p1), (l2, kv2, g2, p2) = out
    assert torch.equal(l1, l2) and np.array_equal(g1, g2)
    assert torch.equal(kv1["k"], kv2["k"]) and torch.equal(kv1["v"],
                                                           kv2["v"])
    assert not kv1["k"][:, :, :, 13 + 4:].any()   # prompt, 4 decodes
    assert p1["passes"] == 1 and p2["passes"] == 4
    if granular:
        # each cold expert crosses once per prompt layer-major
        assert p1["demanded_expert_bytes"] <= p2["demanded_expert_bytes"]


def test_layer_major_matches_reference_counters(models, dbs):
    """Layer-major prefill with a padded tail: logits, the demanded expert
    bytes and the routing EMA equal the reference's (padded positions
    enter neither the demanded set nor the EMA)."""
    jcfg, tcfg, jp, tp, _ = models["float32"]
    sched = _schedule(tcfg, dbs, 0.2, True)
    jsubs = jax_graph(jcfg, wdtype=2, expert_granular=True)
    from repro.core import TimingEstimator as JEst
    from repro.core import build_schedule as jsched
    jsch = jsched(int(sum(s.weight_bytes for s in jsubs) * 0.2) + 1, jsubs,
                  JEst(dbs[0], JCLI2), JSetting(batch=2, context=64),
                  tiers=(8,))
    tok = np.random.RandomState(4).randint(0, tcfg.vocab, (2, 13)) \
        .astype(np.int32)
    ex = PipelinedExecutor(tcfg, tp, sched, max_seq=64, device="cpu")
    last, _, _ = ex.prefill(torch.from_numpy(tok))
    jex = JExecutor(jcfg, jp, jsch, max_seq=64)
    jlast, _, _ = jex.prefill(jnp.asarray(tok))
    np.testing.assert_allclose(last.numpy(), np.asarray(jlast), rtol=2e-5,
                               atol=2e-5)
    for key in COUNTERS:
        assert getattr(ex.stats, key) == getattr(jex.stats, key), key
    assert ex.stats.prefill_stats[0]["demanded_expert_bytes"] == \
        jex.stats.prefill_stats[0]["demanded_expert_bytes"]
    for layer, freqs in ex.expert_ema.items():
        assert np.array_equal(freqs, jex.expert_ema[layer])


def test_decode_demand_bounded_by_tokens_times_top_k(models, dbs):
    """At 0.2x no expert is pinned: each decode pass demands at most
    batch * top_k experts per layer, well below all experts."""
    jcfg, tcfg, _, tp, total = models["float32"]
    sess = _open(models["float32"], dbs, 0.2)
    assert not any(".expert" in n for n in sess.schedule.pinned_weight_map())
    _serve(sess)
    ex = sess.executor.stats
    e_wb = expert_weight_bytes(tcfg, 2)
    assert ex.pass_expert_stats
    for ps in ex.pass_expert_stats:
        assert len(ps["layer_demanded"]) == tcfg.n_layers
        assert max(ps["layer_demanded"]) <= MAX_BATCH * tcfg.moe.top_k
        assert ps["demanded_bytes"] == ps["demanded"] * e_wb
        assert ps["hits"] == 0


def test_no_expert_stack_on_the_device(models, dbs):
    """The executor keeps each expert as a tree of its own: no leaf of a
    pinned sub-layer, monolithic or granular, has the (E, ...) axis."""
    for granular in (True, False):
        ex = _open(models["float32"], dbs, 2.0,
                   expert_granular=granular).executor
        for tree in ex._pinned.values():
            for t in tree_leaves(tree):
                assert not (t.ndim >= 3 and t.shape[0] == 8), t.shape


def test_update_budget_swaps_single_experts_bit_identically(model, dbs):
    jcfg, _, jp, _, total = model
    live = _open(model, dbs, 2.0)
    reqs = _reqs(Request, jcfg.vocab)
    live.serve(reqs, max_batch=MAX_BATCH, max_iterations=2)
    assert any(sl is not None for sl in live.batcher().slots)
    diff = live.update_budget(int(total * 0.5) + 1)
    moved = diff.to_evict + diff.to_pin
    assert [n for n in moved if ".expert" in n], "moved no single expert"
    ex = live.executor.stats
    assert (ex.rebind_pinned_bytes, ex.rebind_evicted_bytes) == \
        (diff.pin_bytes, diff.evict_bytes)
    live.serve([])
    fresh = _open(model, dbs, 0.5)
    assert [r.generated for r in reqs] == _serve(fresh)
    # the same delta as the reference's (its EMA refines the same way)
    js = repro.Session.open(jcfg, JCLI2, int(total * 2.0) + 1,
                            JSetting(batch=MAX_BATCH, context=MAX_SEQ),
                            db=jax_install(JCLI2, quick=True), params=jp,
                            max_seq=MAX_SEQ)
    js.serve(_reqs(JRequest, jcfg.vocab), max_batch=MAX_BATCH,
             max_iterations=2)
    jdiff = js.update_budget(int(total * 0.5) + 1)
    assert (diff.to_pin, diff.to_evict, diff.pin_bytes, diff.evict_bytes) \
        == (jdiff.to_pin, jdiff.to_evict, jdiff.pin_bytes, jdiff.evict_bytes)


def test_fused_serving_reports_expert_hit_rate(models, dbs):
    sess = _open(models["float32"], dbs, 2.0)
    _serve(sess)
    ex = sess.executor.stats
    e_wb = expert_weight_bytes(sess.cfg, 2)
    assert ex.expert_demanded > 0 and ex.expert_hit_rate == 1.0
    assert ex.demanded_expert_bytes == 0
    assert ex.resident_expert_bytes == \
        sess.cfg.n_layers * sess.cfg.moe.n_experts * e_wb
    st = sess.stats()
    assert st["serving"]["expert_hit_rate"] == 1.0
    assert st["executor"]["resident_expert_bytes"] == \
        ex.resident_expert_bytes


# ------------------------------------------------------------ planning
def test_explicit_expert_granular_conflicts_raise(dbs):
    dense = torch_smoke("yi-9b")
    with pytest.raises(ValueError, match="MoE config"):
        Session.open(dense, CLI2, 1 << 20, InferenceSetting(batch=1),
                     db=dbs[1], expert_granular=True, device="cpu")
    moe = torch_smoke(ARCH)
    assert Session.open(moe, CLI2, 1 << 20, InferenceSetting(batch=1),
                        db=dbs[1], device="cpu").expert_granular
    assert not Session.open(dense, CLI2, 1 << 20, InferenceSetting(batch=1),
                            db=dbs[1], device="cpu").expert_granular


def test_hot_experts_pin_first_from_routing_stats(dbs):
    cfg = torch_smoke(ARCH)
    E = cfg.moe.n_experts
    hot = {1, 5}
    freqs = [0.45 if e in hot else 0.1 / (E - 2) for e in range(E)]
    routing = {layer: freqs for layer in range(cfg.n_layers)}
    subs = build_graph(cfg, wdtype=2, expert_granular=True, routing=routing)
    setting = InferenceSetting(batch=2, context=64)
    est = TimingEstimator(dbs[1], CLI2)
    probe = build_schedule(1 << 40, subs, est, setting)
    fixed = sum(b for n, b in probe.pinned_weight_map().items()
                if ".expert" not in n)
    kv = sum(s.bytes_resident(setting) for s in subs if s.kind == "kv")
    budget = probe.scratch_bytes + fixed + kv \
        + cfg.n_layers * 2 * expert_weight_bytes(cfg, 2)
    pinned = build_schedule(budget, subs, est, setting).pinned_weight_map()
    experts = [n for n in pinned if ".expert" in n]
    assert experts and all(int(n.rsplit("expert", 1)[1]) in hot
                           for n in experts)


def test_session_ema_refines_routing_stats(models, dbs):
    """Serving refines the EMA; a re-plan writes it to the profile DB and
    the expert shards' ``hot``, as the reference does."""
    jcfg, tcfg, jp, tp, total = models["float32"]
    db = run_install(CLI2, quick=True)
    s = Session.open(tcfg, CLI2, int(total * 2.0) + 1,
                     InferenceSetting(batch=2, context=64), db=db,
                     params=tp, max_seq=64, device="cpu")
    prompts = np.random.RandomState(2).randint(0, tcfg.vocab, (2, 8))
    s.generate(prompts, 4)
    ema = s.executor.expert_ema
    assert sorted(ema) == list(range(tcfg.n_layers))
    jdb = jax_install(JCLI2, quick=True)
    js = repro.Session.open(jcfg, JCLI2, int(total * 2.0) + 1,
                            JSetting(batch=2, context=64), db=jdb,
                            params=jp, max_seq=64)
    js.generate(prompts, 4)
    for layer, freqs in ema.items():
        assert np.array_equal(freqs, js.executor.expert_ema[layer])
    s.update_budget(int(total * 1.0) + 1)
    routing = s.db.get_routing(tcfg.name)
    for layer, freqs in routing.items():
        np.testing.assert_allclose(freqs, ema[layer])
    for sub in s.subs:
        if sub.kind == "moe_expert":
            assert sub.meta["hot"] == pytest.approx(
                float(ema[sub.layer][sub.meta["expert"]]))


@pytest.mark.parametrize("kw", [{}, dict(expert_quant="int8"),
                                dict(weight_quant="int4")])
def test_graph_and_schedule_equal_reference(dbs, kw):
    """graphing and the planner's integers equal the reference's for the
    MoE smoke config, granular and monolithic."""
    from repro.core import TimingEstimator as JEst
    from repro.core import build_schedule as jsched
    tcfg, jcfg = torch_smoke(ARCH).replace(**kw), jax_smoke(ARCH) \
        .replace(**kw)
    for granular in (True, False):
        subs = build_graph(tcfg, wdtype=2, expert_granular=granular)
        jsubs = jax_graph(jcfg, wdtype=2, expert_granular=granular)
        assert [(s.name, s.weight_bytes) for s in subs] == \
            [(s.name, s.weight_bytes) for s in jsubs]
        budget = int(sum(s.weight_bytes for s in subs) * 0.3) + 1
        a = build_schedule(budget, subs, TimingEstimator(dbs[1], CLI2),
                           InferenceSetting(batch=2, context=64))
        b = jsched(budget, jsubs, JEst(dbs[0], JCLI2),
                   JSetting(batch=2, context=64))
        assert a.pinned_weight_map() == b.pinned_weight_map()
        assert (a.scratch_bytes, a.pinned_bytes) == (b.scratch_bytes,
                                                     b.pinned_bytes)


def test_own_init_makes_the_reference_layout():
    """The port's seeded init: the reference's MoE leaves, shapes and
    dtypes, with each expert_quant / weight_quant mode."""
    for kw in ({}, dict(expert_quant="int8"), dict(weight_quant="int4")):
        tcfg = torch_smoke(ARCH).replace(**kw)
        jcfg = jax_smoke(ARCH).replace(**kw)
        own = torch_build(tcfg).init(torch.Generator().manual_seed(0))
        ref = jax_build(jcfg).init(jax.random.PRNGKey(0))
        jm, tm = ref["layers"]["moe"], own["layers"]["moe"]
        assert {k: (tuple(v.shape), str(v.dtype)) for k, v in jm.items()} \
            == {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
                for k, v in tm.items()}
