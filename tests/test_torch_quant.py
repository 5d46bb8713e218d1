"""Quantised weight streaming (``weight_quant`` int8 / int4) of the PyTorch
port against the JAX package, on the CPU.

- the quantisers and dequantisers are byte-equal to the reference's on the
  same numpy-seeded f32 and bf16 inputs, ragged K and leading batch dims
  included;
- the param bridge carries a quantised tree bit for bit, and the port's own
  quantised init weighs what the graph prices;
- graphs, schedules and per-dtype streamed bytes equal the reference's;
- the engine's FFN step (through K2 / K3's plain versions) matches the
  reference's fused Pallas path run in interpret mode, or its jnp dequant
  path where the reference vetoes ragged groups; the monolithic FFN and
  logits match in fp32 (tight) and bf16 (2e-2);
- greedy agreement of the quantised port with the fp16 port stays above the
  reference's floors.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.core import CLI2 as JCLI2
from repro.core import InferenceSetting as JSetting
from repro.core import TimingEstimator as JEstimator
from repro.core import build_graph as jax_graph
from repro.core import build_schedule as jax_schedule
from repro.core import ffn_weight_bytes
from repro.core import run_install as jax_install
from repro.core.engine import SubLayerEngine
from repro.kernels import streamed_matmul as jsm
from repro.models import build_model as jax_build
from repro.models import mlp as jmlp
from repro.models.common import NoPolicy
from repro_torch import Session
from repro_torch.configs import get_smoke_config as torch_smoke
from repro_torch.core import CLI2, InferenceSetting, TimingEstimator
from repro_torch.core import build_graph, build_schedule, run_install
from repro_torch.core import engine as teng
from repro_torch.kernels import streamed_matmul as tsm
from repro_torch.models import build_model as torch_build
from repro_torch.models import mlp as tmlp
from repro_torch.models.api import params_from_numpy, tensor_from_numpy
from repro_torch.models.common import tree_leaves, tree_nbytes
from repro_torch.models.transformer import layer_slice, quantize_params

torch.set_num_threads(1)

MODES = ("int8", "int4")
TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
BUDGETS = (2.0, 0.25, 0.1)


def _np(x):
    if torch.is_tensor(x):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(x, np.float32)


def _bytes(a):
    """The raw bytes of a numpy array or tensor, with its dtype name."""
    if torch.is_tensor(a):
        dt = str(a.dtype).split(".")[-1]
        return dt, a.contiguous().view(torch.uint8).numpy().tobytes()
    a = np.ascontiguousarray(a)
    return a.dtype.name, a.view(np.uint8).tobytes()


def _weight(seed, shape, dtype):
    a = np.random.default_rng(seed).standard_normal(shape)
    j = jnp.asarray(a, dtype)
    return j, tensor_from_numpy(np.asarray(j))


# ------------------------------------------------------------ quantisers
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("K", [128, 250, 384, 700, 896])
def test_quantize_int8_byte_equal(K, dtype):
    jw, tw = _weight(K, (K, 48), dtype)
    for block_k in (128, 512):
        for a, b in zip(jsm.quantize_int8(jw, block_k=block_k),
                        tsm.quantize_int8(tw, block_k=block_k)):
            assert _bytes(np.asarray(a)) == _bytes(b)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("K", [128, 250, 384, 700, 896])
def test_quantize_int4_byte_equal(K, dtype):
    jw, tw = _weight(K + 1, (K, 48), dtype)
    for group in (64, 128):
        out = tsm.quantize_int4(tw, group_size=group)
        for a, b in zip(jsm.quantize_int4(jw, group_size=group), out):
            assert _bytes(np.asarray(a)) == _bytes(b)
        G = -(-K // group)
        assert [tuple(t.shape) for t in out] == [(K // 2, 48), (G, 48),
                                                 (G, 48)]


def test_quantize_int4_odd_k_raises():
    with pytest.raises(ValueError, match="K=63"):
        tsm.quantize_int4(torch.zeros(63, 8))


@pytest.mark.parametrize("K", [256, 250, 700])
def test_dequantisers_bit_equal_with_batch_dims(K):
    """Three stacked matrices (a leading batch dim, as per-layer stacks
    and expert stacks have) through each dequantiser."""
    jw, _ = _weight(K + 2, (3, K, 40), jnp.float32)
    q8 = jax.vmap(lambda w: jsm.quantize_int8(w, block_k=128))(jw)
    q4 = jax.vmap(jsm.quantize_int4)(jw)
    t8 = [tensor_from_numpy(np.asarray(a)) for a in q8]
    t4 = [tensor_from_numpy(np.asarray(a)) for a in q4]
    assert _bytes(np.asarray(jsm.dequant_int8(*q8))) == \
        _bytes(tsm.dequant_int8(*t8))
    assert _bytes(np.asarray(jsm.unpack_int4(q4[0]))) == \
        _bytes(tsm.unpack_int4(t4[0]))
    assert _bytes(np.asarray(jsm.dequant_int4(*q4))) == \
        _bytes(tsm.dequant_int4(*t4))
    # one matrix of the stack alone gives the same values
    assert torch.equal(tsm.dequant_int4(*(t[1] for t in t4)),
                       tsm.dequant_int4(*t4)[1])


# ------------------------------------------------------------ bridge, graph
def _quant_models(arch, mode, dtype="bfloat16"):
    jcfg = jax_smoke(arch).replace(dtype=dtype, weight_quant=mode)
    tcfg = torch_smoke(arch).replace(dtype=dtype, weight_quant=mode)
    jp = jax_build(jcfg).init(jax.random.PRNGKey(0))
    return jcfg, tcfg, jp, params_from_numpy(jax.tree.map(np.asarray, jp))


@pytest.mark.parametrize("mode", MODES)
def test_param_bridge_bit_exact_quantised(mode):
    """Every leaf and key of a quantised JAX tree (w_*, s_*, and z_* for
    int4) crosses the bridge bit for bit, in its stacked layout; the port's
    quantiser on the bridged fp16 weights gives the same tree."""
    jcfg, tcfg, jp, tp = _quant_models("qwen2-0.5b", mode)
    jl = jax.tree_util.tree_leaves_with_path(jp)
    tl = {tuple(p): v for p, v in _paths(tp)}
    assert len(jl) == len(tl)
    for path, leaf in jl:
        key = tuple(k.key for k in path)
        assert _bytes(np.asarray(leaf)) == _bytes(tl[key]), key
        assert tuple(tl[key].shape) == tuple(leaf.shape), key
    ffn = tp["layers"]["ffn"]
    L, G = jcfg.n_layers, 1          # smoke widths: one group per matrix
    want = {"w_gate": torch.int8, "s_gate": torch.float32} if mode == "int8" \
        else {"w_gate": torch.uint8, "s_gate": torch.float16,
              "z_gate": torch.uint8}
    assert {k: ffn[k].dtype for k in want} == want
    if mode == "int8":
        assert tuple(ffn["s_gate"].shape) == (L, G, 1, jcfg.d_ff)
    else:
        assert tuple(ffn["s_gate"].shape) == (L, G, jcfg.d_ff)
        assert tuple(ffn["z_down"].shape) == (L, G, jcfg.d_model)
    fp = jax_build(jcfg.replace(weight_quant="fp16")).init(
        jax.random.PRNGKey(0))
    tq = quantize_params(params_from_numpy(jax.tree.map(np.asarray, fp)),
                         mode)
    for k, v in tq["layers"]["ffn"].items():
        assert _bytes(v) == _bytes(ffn[k]), k
    # the executor's per-layer view hands over the s_*/z_* keys
    assert set(layer_slice(tp["layers"], 1)["ffn"]) == set(ffn)


def _paths(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, prefix + (k,))
    else:
        yield prefix, tree


@pytest.mark.parametrize("mode", ("fp16",) + MODES)
def test_ffn_byte_accounting(mode):
    """The port's own quantised FFN tree weighs what the graph prices."""
    cfg = torch_smoke("yi-9b").replace(weight_quant=mode)
    sub = next(s for s in build_graph(cfg, wdtype=2) if s.kind == "ffn")
    assert sub.weight_bytes == ffn_weight_bytes(cfg, 2)
    assert sub.meta["quant"] == mode
    p = tmlp.init_ffn_params(torch.Generator().manual_seed(0), cfg,
                             torch.bfloat16)
    assert tree_nbytes(p) == sub.weight_bytes
    if mode != "fp16":
        assert sub.weight_bytes < ffn_weight_bytes(
            cfg.replace(weight_quant="fp16"), 2)


@pytest.fixture(scope="module")
def dbs():
    return jax_install(JCLI2, quick=True), run_install(CLI2, quick=True)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("arch", ["qwen2-0.5b", "yi-9b"])
def test_graph_schedule_and_dtype_bytes_match_reference(dbs, arch, mode):
    jcfg = jax_smoke(arch).replace(weight_quant=mode)
    tcfg = torch_smoke(arch).replace(weight_quant=mode)
    jsubs, tsubs = jax_graph(jcfg, wdtype=2), build_graph(tcfg, wdtype=2)
    assert [(s.name, s.kind, s.weight_bytes, s.meta) for s in jsubs] == \
        [(s.name, s.kind, s.weight_bytes, s.meta) for s in tsubs]
    total = sum(s.weight_bytes for s in tsubs)
    for frac in BUDGETS:
        js = jax_schedule(int(total * frac) + 1, jsubs,
                          JEstimator(dbs[0], JCLI2),
                          JSetting(batch=2, context=48))
        ts = build_schedule(int(total * frac) + 1, tsubs,
                            TimingEstimator(dbs[1], CLI2),
                            InferenceSetting(batch=2, context=48))
        assert sorted(js.tiers) == sorted(ts.tiers)
        for t in ts.tiers:
            jp, tp = js.tiers[t].plan, ts.tiers[t].plan
            assert tp.name == jp.name
            assert [(p.sub.name, p.engine, p.streamed)
                    for p in tp.placements] == \
                [(p.sub.name, p.engine, p.streamed) for p in jp.placements]
            by = tp.streamed_weight_bytes_by_dtype()
            assert by == jp.streamed_weight_bytes_by_dtype()
            assert sum(by.values()) == tp.streamed_weight_bytes()
            assert set(by) <= {"fp16", mode}
        assert ts.scratch_bytes == js.scratch_bytes
        assert ts.pinned_bytes == js.pinned_bytes


# ------------------------------------------------------------ engine, model
def _ffn_case(mode, d, f, dtype="float32"):
    """One FFN sub-layer's weights in both packages (the port's through
    the bridge) and a seeded (2, 5, d) activation."""
    jcfg = jax_smoke("qwen2-0.5b").replace(
        name="quant-ffn", d_model=d, d_ff=f, dtype=dtype, weight_quant=mode)
    tcfg = torch_smoke("qwen2-0.5b").replace(
        name="quant-ffn", d_model=d, d_ff=f, dtype=dtype, weight_quant=mode)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    jp = jmlp.init_ffn_params(jax.random.PRNGKey(f), jcfg, jdt)
    ln = jnp.asarray(np.random.default_rng(d).uniform(0.5, 1.5, d), jdt)
    jw = {"ffn": jp, "ln2": ln}
    tw = params_from_numpy(jax.tree.map(np.asarray, jw))
    x = jnp.asarray(np.random.default_rng(f).standard_normal((2, 5, d)), jdt)
    return jcfg, tcfg, jw, tw, x, tensor_from_numpy(np.asarray(x))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("d,f,fused", [(56, 112, True), (256, 512, True),
                                       (256, 250, False)])
def test_ffn_step_matches_reference_streamed(mode, d, f, fused):
    """The port's FFN step (K2 / K3 plain versions) against the
    reference's ``ffn_step(streamed=True)``: its fused Pallas kernels in
    interpret mode where its gate admits the shape, its jnp dequant path
    where it vetoes the shape (f=250: 250 % 128 != 0, and 2 groups of 125,
    odd for int4)."""
    jcfg, tcfg, jw, tw, x, tx = _ffn_case(mode, d, f)
    eng = SubLayerEngine(jcfg, use_streamed_mm=True)
    assert eng._streamed_mm_ok(x.shape, jw["ffn"]) == fused
    ref = eng.ffn_step(jw, x, streamed=True)
    out = teng.ffn_step(tcfg, tw, tx)
    np.testing.assert_allclose(_np(out), _np(ref), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", MODES)
def test_monolithic_ffn_matches_reference(mode, dtype):
    jcfg, tcfg, jw, tw, x, tx = _ffn_case(mode, 256, 250, dtype)
    ref = jmlp.ffn(jw["ffn"], jcfg, x, NoPolicy())
    out = tmlp.ffn(tw["ffn"], tcfg, tx)
    assert out.dtype == tx.dtype
    np.testing.assert_allclose(_np(out), _np(ref), **TOL[dtype])
    for name in ("w_up", "w_down"):
        assert _bytes(np.asarray(jmlp._dequant(jw["ffn"], name, x.dtype))) \
            == _bytes(tmlp._dequant(tw["ffn"], name, tx.dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", MODES)
def test_monolithic_logits_match_quantised(mode, dtype):
    jcfg, tcfg, jp, tp = _quant_models("qwen2-0.5b", mode, dtype)
    tok = np.random.RandomState(0).randint(0, jcfg.vocab, (2, 12))
    jl, _ = jax_build(jcfg).apply(jp, {"tokens": jnp.asarray(tok)})
    tl, _ = torch_build(tcfg).apply(tp, {"tokens": torch.from_numpy(tok)})
    np.testing.assert_allclose(_np(tl), _np(jl), **TOL[dtype])


@pytest.mark.parametrize("mode,floor", [("int8", 0.85), ("int4", 0.55)])
def test_greedy_agreement_with_fp16_port(mode, floor):
    """Teacher-forced per-position greedy agreement of the quantised port
    with the fp16 port on the same weights stays at or above the
    reference's floors (tests/test_quant_stream.py, yi-9b smoke)."""
    cfg = torch_smoke("yi-9b")
    params = torch_build(cfg).init(torch.Generator().manual_seed(0))
    tok = torch.from_numpy(
        np.random.RandomState(3).randint(0, cfg.vocab, (2, 32)))

    def greedy(c, p):
        lg, _ = torch_build(c).apply(p, {"tokens": tok})
        return lg.to(torch.float32).argmax(-1)

    qcfg = cfg.replace(weight_quant=mode)
    qp = quantize_params(params, mode)
    agree = (greedy(qcfg, qp) == greedy(cfg, params)).float().mean().item()
    assert agree >= floor, agree
    # the port's quantised init draws the same weights, then quantises
    init = torch_build(qcfg).init(torch.Generator().manual_seed(0))
    assert all(torch.equal(a, b) for a, b in
               zip(tree_leaves(init), tree_leaves(qp)))


# ------------------------------------------------------------ MoE weights
def test_stacked_expert_weights_raise_naming_moe():
    """Stacked (E, K, N) expert weights, which raised before MoE was
    ported, now quantise one expert at a time (the reference vmaps), and
    a per-expert int8 weight dequantises with its (1, 1) scale."""
    w = torch.randn(4, 8, 16, generator=torch.Generator().manual_seed(3))
    q = tmlp.quantize_weight_tree({"w_gate": w}, "int8")
    for e in range(4):
        qe, se = tsm.quantize_int8(w[e], block_k=tsm.GROUP_SIZE)
        assert torch.equal(q["w_gate"][e], qe) and torch.equal(
            q["s_gate"][e], se)
    per_expert = {"w_up": torch.full((8, 16), 3, dtype=torch.int8),
                  "s_up": torch.full((1, 1), 0.5)}
    assert torch.equal(tmlp._dequant(per_expert, "w_up", torch.float32),
                       torch.full((8, 16), 1.5))


@pytest.mark.parametrize("arch,kw", [
    ("qwen2-0.5b", dict(expert_quant="int8")),
    ("qwen30b-a3b", dict(weight_quant="int4")),
    ("qwen30b-a3b", dict(expert_quant="int8")),
])
def test_moe_quant_options_raise_naming_moe(dbs, arch, kw):
    """These options raised before MoE was ported; now each session opens
    and plans the reference's graph (expert_quant is a no-op on a dense
    model, as there)."""
    cfg = torch_smoke(arch).replace(**kw)
    sess = Session.open(cfg, CLI2, 1 << 30, db=dbs[1], device="cpu")
    jcfg = jax_smoke(arch).replace(**kw)
    jsubs = jax_graph(jcfg, wdtype=2, expert_granular=jcfg.moe is not None)
    assert [(s.name, s.kind, s.weight_bytes, s.meta.get("quant"))
            for s in sess.subs] == \
        [(s.name, s.kind, s.weight_bytes, s.meta.get("quant"))
         for s in jsubs]
