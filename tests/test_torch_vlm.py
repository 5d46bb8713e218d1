"""The port's VLM path against the JAX reference, on the CPU.

- M-RoPE: ``apply_mrope`` against the reference's, and equal to RoPE when
  the three position axes are equal;
- qwen2-vl-7b (smoke): the param bridge, the monolithic forward with
  vision embeddings and 3D positions, and cached prefill + decode, against
  the reference's (fp32 tight, bf16 2e-2);
- VLMOpt: the analytic VRAM model's integers equal to the reference's over
  the whole grid; ``vision_encode`` flash (K4's plain version here) and
  plain against the reference's, and flash == plain at a ragged N the
  reference cannot run;
- a planning-only VLM ``Session`` at full width: schedule and estimates
  equal to the reference's field for field; its executor raises.

Inputs are made from seeds with numpy and handed to both packages; the JAX
package's parameters reach the port through the numpy param bridge.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro
from repro.configs import get_config as jax_full
from repro.configs import get_smoke_config as jax_smoke
from repro.core import install as jinstall
from repro.core import vlmopt as jvlm
from repro.core.system import InferenceSetting as JSetting
from repro.core.system import SystemConfig as JSystem
from repro.models import build_model as jax_build
from repro.models import common as jcommon
from repro_torch import Session
from repro_torch.configs import get_config as torch_full
from repro_torch.configs import get_smoke_config as torch_smoke
from repro_torch.core import SYSTEMS, InferenceSetting, run_install
from repro_torch.core import vlmopt as tvlm
from repro_torch.models import attention as tattn
from repro_torch.models import build_model as torch_build
from repro_torch.models import common as tcommon
from repro_torch.models.api import params_from_numpy, tensor_from_numpy

torch.set_num_threads(1)

ARCH = "qwen2-vl-7b"
TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
DT = {"float32": (jnp.float32, torch.float32),
      "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _np(x):
    if torch.is_tensor(x):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(x, np.float32)


def _leaves_equal(jtree, ttree):
    """Every leaf of the reference's tree, bridged, equals the port's bit
    for bit (same keys, shapes and dtypes)."""
    jl = jax.tree_util.tree_leaves_with_path(jtree)
    assert len(jl) == len(tcommon.tree_leaves(ttree))
    for path, leaf in jl:
        t = ttree
        for k in path:
            t = t[k.key]
        assert torch.equal(t, tensor_from_numpy(np.asarray(leaf))), path


# ------------------------------------------------------------ M-RoPE
@pytest.mark.parametrize("hd", [8, 16, 64, 128])
def test_apply_mrope_matches_reference(hd):
    rng = np.random.default_rng(hd)
    x = rng.standard_normal((2, 9, 3, hd)).astype(np.float32)
    pos = rng.integers(0, 500, (3, 2, 9)).astype(np.int32)
    ref = jcommon.apply_mrope(jnp.asarray(x), jnp.asarray(pos), 1e6)
    out = tcommon.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos),
                              1e6)
    np.testing.assert_allclose(_np(out), _np(ref), rtol=2e-5, atol=2e-5)
    xb = jnp.asarray(x, jnp.bfloat16)
    refb = jcommon.apply_mrope(xb, jnp.asarray(pos), 1e6)
    outb = tcommon.apply_mrope(tensor_from_numpy(np.asarray(xb)),
                               torch.from_numpy(pos), 1e6)
    assert outb.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(outb), _np(refb), **TOL["bfloat16"])


def test_mrope_sections_scale_to_half_head_dim():
    """(16, 24, 24) over hd/2 = 4 slots: floor gives 1 and 1, the last
    section the remainder, 2 (the smoke config's hd = 8)."""
    axes = tcommon._mrope_axes(4, (16, 24, 24), torch.device("cpu"))
    assert axes.tolist() == [0, 1, 2, 2]
    assert tcommon._mrope_axes(4, (16, 24, 24), torch.device("cpu")) \
        is axes


def test_mrope_equals_rope_when_positions_equal():
    """With t == h == w position ids, M-RoPE reduces to plain RoPE (a
    port of tests/test_attention.py)."""
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (2, 8, 4, 64)).astype(np.float32))
    pos = torch.arange(8)[None, :].expand(2, 8)
    a = tcommon.apply_rope(x, pos, 1e6)
    b = tcommon.apply_mrope(x, torch.stack([pos, pos, pos]), 1e6)
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------ qwen2-vl-7b
@pytest.fixture(scope="module")
def models():
    out = {}
    for dtype in ("float32", "bfloat16"):
        jcfg = jax_smoke(ARCH).replace(dtype=dtype)
        tcfg = torch_smoke(ARCH).replace(dtype=dtype)
        jp = jax_build(jcfg).init(jax.random.PRNGKey(0))
        out[dtype] = (jcfg, tcfg, jp,
                      params_from_numpy(jax.tree.map(np.asarray, jp)))
    return out


def _vlm_batch(cfg, seed, B, T):
    """Numpy tokens, bf16 vision embeddings and 3D positions: vision token
    i at (0, i // 4, i % 4), text token j at 4 + j on every axis."""
    rng = np.random.default_rng(seed)
    nv = cfg.n_vision_tokens
    tokens = rng.integers(0, cfg.vocab, (B, T)).astype(np.int32)
    vis = np.asarray(jnp.asarray(rng.standard_normal((B, nv, cfg.d_model)),
                                 jnp.bfloat16))
    i = np.arange(nv)
    vpos = np.stack([np.zeros(nv), i // 4, i % 4]).astype(np.int32)
    tpos = np.broadcast_to(4 + np.arange(T), (3, T)).astype(np.int32)
    pos = np.broadcast_to(np.concatenate([vpos, tpos], 1)[:, None],
                          (3, B, nv + T)).copy()
    return tokens, vis, pos


def _jbatch(tokens, vis, pos):
    b = {"tokens": jnp.asarray(tokens), "positions": jnp.asarray(pos)}
    if vis is not None:
        b["vision_embeds"] = jnp.asarray(vis)
    return b


def _tbatch(tokens, vis, pos):
    b = {"tokens": torch.from_numpy(tokens),
         "positions": torch.from_numpy(pos)}
    if vis is not None:
        b["vision_embeds"] = tensor_from_numpy(vis)
    return b


def test_param_bridge_bit_exact(models):
    jcfg, tcfg, jp, tp = models["bfloat16"]
    _leaves_equal(jp, tp)
    # the port's own init draws the same tree (keys, shapes, dtypes)
    own = torch_build(tcfg).init(torch.Generator().manual_seed(0))

    def spec(tree):
        return tcommon.tree_map(lambda t: (tuple(t.shape), t.dtype), tree)
    assert spec(own) == spec(tp)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_monolithic_logits_match(models, dtype):
    jcfg, tcfg, jp, tp = models[dtype]
    tokens, vis, pos = _vlm_batch(jcfg, 7, 2, 11)
    jl, _ = jax_build(jcfg).apply(jp, _jbatch(tokens, vis, pos))
    tl, _ = torch_build(tcfg).apply(tp, _tbatch(tokens, vis, pos))
    assert tuple(tl.shape) == (2, jcfg.n_vision_tokens + 11, jcfg.vocab)
    np.testing.assert_allclose(_np(tl), _np(jl), **TOL[dtype])
    # the nn.Module takes the same inputs and computes the same logits
    b = _tbatch(tokens, vis, pos)
    ml, _ = torch_build(tcfg).module(tp)(
        b["tokens"], vision_embeds=b["vision_embeds"],
        positions=b["positions"])
    assert torch.equal(ml, tl)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_step_match(models, dtype):
    """Model.prefill then Model.decode_step against the reference's (the
    check of tests/test_models_smoke.py), and the decoded logits against
    the no-cache forward's last row."""
    jcfg, tcfg, jp, tp = models[dtype]
    B, T, S = 2, 8, 24
    tokens, vis, pos = _vlm_batch(jcfg, 8, B, T)
    Ttot = jcfg.n_vision_tokens + T
    jm, tm = jax_build(jcfg), torch_build(tcfg)
    pre = (tokens[:, :-1], vis, pos[:, :, :Ttot - 1])
    dec = (tokens[:, -1:], None, pos[:, :, Ttot - 1:])
    jc = jm.init_cache(B, S)
    tc = tm.init_cache(B, S, device="cpu")
    jlast, jc = jm.prefill(jp, _jbatch(*pre), jc)
    tlast, tc2 = tm.prefill(tp, _tbatch(*pre), tc)
    assert tc2 is tc                      # written in place
    assert tuple(tlast.shape) == (B, 1, jcfg.vocab)
    np.testing.assert_allclose(_np(tlast), _np(jlast), **TOL[dtype])
    np.testing.assert_allclose(_np(tc["k"]), _np(jc["k"]), **TOL["bfloat16"])
    jd, _ = jm.decode_step(jp, _jbatch(*dec), jc, jnp.int32(Ttot - 1))
    td, _ = tm.decode_step(tp, _tbatch(*dec), tc, Ttot - 1)
    np.testing.assert_allclose(_np(td), _np(jd), **TOL[dtype])
    full, _ = tm.apply(tp, _tbatch(tokens, vis, pos))
    a, b = _np(full[:, -1]), _np(td[:, -1])
    assert np.max(np.abs(a - b)) / (np.max(np.abs(a)) + 1e-9) < 0.05


def test_unported_positions_raise():
    """Sinusoidal positions (the audio family) are a later slice."""
    cfg = torch_smoke("qwen2-0.5b").replace(pos="sin")
    p = tattn.init_attn_params(torch.Generator().manual_seed(0), cfg,
                               torch.float32)
    with pytest.raises(NotImplementedError, match="audio slice"):
        tattn.qkv_project(p, cfg, torch.zeros(1, 3, cfg.d_model),
                          torch.arange(3)[None])


# ------------------------------------------------------------ VLMOpt
VC = tvlm.VisionConfig()
JVC = jvlm.VisionConfig()


def test_vlmopt_analytic_integers_match():
    assert dataclasses.asdict(VC) == dataclasses.asdict(JVC)
    assert tvlm.RESOLUTIONS == jvlm.RESOLUTIONS
    assert tvlm.vision_weight_bytes(VC) == jvlm.vision_weight_bytes(JVC) \
        == 1_258_291_200
    lang = (0, int(1.2e9), int(4e9))
    for res in tvlm.RESOLUTIONS:
        assert tvlm.n_vision_tokens(VC, res) == jvlm.n_vision_tokens(JVC, res)
        for offload in (False, True):
            for flash in (False, True):
                for qc in (128, 663, 1024, 4096):
                    got = tvlm.vision_vram_demand(VC, res, offload=offload,
                                                  flash=flash, q_chunk=qc)
                    want = jvlm.vision_vram_demand(JVC, res, offload=offload,
                                                   flash=flash, q_chunk=qc)
                    assert type(got) is int and got == want
        for lb in lang:
            assert tvlm.language_vram_demand(None, lb) == \
                jvlm.language_vram_demand(None, lb)
            for opt in (False, True):
                for qc in (128, 1024):
                    assert tvlm.vlm_peak_vram(VC, res, lb, vlmopt=opt,
                                              q_chunk=qc) == \
                        jvlm.vlm_peak_vram(JVC, res, lb, vlmopt=opt,
                                           q_chunk=qc)
                assert tvlm.min_feasible_budget(VC, res, lb, vlmopt=opt) == \
                    jvlm.min_feasible_budget(JVC, res, lb, vlmopt=opt)


SMALL = dict(d=64, layers=2, heads=4)


@pytest.fixture(scope="module")
def vision_params():
    out = {}
    for dtype in ("float32", "bfloat16"):
        jp = jvlm.init_vision_params(jax.random.PRNGKey(0),
                                     jvlm.VisionConfig(**SMALL),
                                     DT[dtype][0])
        out[dtype] = (jp, params_from_numpy(jax.tree.map(np.asarray, jp)))
    return out


def test_init_vision_params_bridge_bit_exact(vision_params):
    jp, tp = vision_params["bfloat16"]
    _leaves_equal(jp, tp)
    own = tvlm.init_vision_params(torch.Generator().manual_seed(0),
                                  tvlm.VisionConfig(**SMALL), torch.bfloat16)
    assert {k: (tuple(v.shape), v.dtype) for k, v in own.items()} == \
        {k: (tuple(v.shape), v.dtype) for k, v in tp.items()}
    assert torch.equal(own["ln1"], torch.ones(2, 64, dtype=torch.bfloat16))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("flash", [True, False])
def test_vision_encode_matches_reference(vision_params, dtype, flash):
    jp, tp = vision_params[dtype]
    jd, _ = DT[dtype]
    x = jnp.asarray(np.random.default_rng(1).standard_normal((2, 128, 64)),
                    jd)
    ref = jvlm.vision_encode(jp, jvlm.VisionConfig(**SMALL), x, flash=flash,
                             q_chunk=32)
    out = tvlm.vision_encode(tp, tvlm.VisionConfig(**SMALL),
                             tensor_from_numpy(np.asarray(x)), flash=flash,
                             q_chunk=32, device="cpu")
    assert out.dtype == DT[dtype][1] and tuple(out.shape) == (2, 128, 64)
    if dtype == "float32":
        np.testing.assert_allclose(_np(out), _np(ref), rtol=2e-4, atol=2e-4)
    else:
        # bf16 rounds the residual stream after every layer, at other
        # places in XLA and torch: the reference's own flash and plain bf16
        # encodes differ by up to 0.0625 at single elements of this input,
        # so bf16 is held to 2e-2 of the output's largest magnitude
        err = np.max(np.abs(_np(out) - _np(ref)))
        assert err <= 2e-2 * np.max(np.abs(_np(ref))), err


def test_vision_encode_ragged_n_flash_equals_plain(vision_params):
    """N = 130: no KV-chunk of min(1024, N) and no Q-chunk below 130
    divides it, so the reference cannot run it; the port's flash encode
    equals its plain encode."""
    _, tp = vision_params["float32"]
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (1, 130, 64)).astype(np.float32))
    vc = tvlm.VisionConfig(**SMALL)
    a = tvlm.vision_encode(tp, vc, x.clone(), flash=True, q_chunk=32,
                           device="cpu")
    b = tvlm.vision_encode(tp, vc, x, flash=False, device="cpu")
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("flash", [True, False])
def test_vision_encode_row_chunks_match_reference(vision_params, dtype,
                                                  flash):
    """N = 100 with q_chunk = 32: the port runs its projections and (flash)
    queries in row chunks of 32, 32, 32 and 4 and its FFNs in four chunks
    of 25 rows, the reference its
    Q-chunk of 25 (the largest divisor of 100 up to 32); the encodes agree
    within the tolerance of ``test_vision_encode_matches_reference``."""
    jp, tp = vision_params[dtype]
    jd, _ = DT[dtype]
    x = jnp.asarray(np.random.default_rng(3).standard_normal((2, 100, 64)),
                    jd)
    ref = jvlm.vision_encode(jp, jvlm.VisionConfig(**SMALL), x, flash=flash,
                             q_chunk=32)
    out = tvlm.vision_encode(tp, tvlm.VisionConfig(**SMALL),
                             tensor_from_numpy(np.asarray(x)), flash=flash,
                             q_chunk=32, device="cpu")
    assert tuple(out.shape) == (2, 100, 64)
    if dtype == "float32":
        np.testing.assert_allclose(_np(out), _np(ref), rtol=2e-4, atol=2e-4)
    else:
        err = np.max(np.abs(_np(out) - _np(ref)))
        assert err <= 2e-2 * np.max(np.abs(_np(ref))), err


@pytest.mark.parametrize("flash", [True, False])
def test_vision_encode_writes_its_result_into_the_patches(vision_params,
                                                          flash):
    """The patches are the residual stream: the encode returns them,
    overwritten with its result, the bits an encode of a clone gives."""
    _, tp = vision_params["bfloat16"]
    vc = tvlm.VisionConfig(**SMALL)
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (1, 70, 64)).astype(np.float32)).to(torch.bfloat16)
    want = tvlm.vision_encode(tp, vc, x.clone(), flash=flash, q_chunk=32,
                              device="cpu")
    assert not torch.equal(want, x)
    got = tvlm.vision_encode(tp, vc, x, flash=flash, q_chunk=32,
                             device="cpu")
    assert got is x and torch.equal(got, want)


@pytest.mark.parametrize("n, rows", [(1, 1), (4, 1), (5, 2), (100, 25),
                                     (4641, 1161), (18564, 4641)])
def test_ffn_rows_fit_the_room_of_k_and_v(n, rows):
    """A chunk of FFN rows holds at most 8 d elements a row (hidden and
    gelu), no more than the 2 N x d of k and v: N / 4 rows, rounded up
    (and so at most four chunks)."""
    assert tvlm.ffn_rows(n) == rows
    assert 8 * rows <= 2 * n + 6
    assert -(-n // rows) <= 4


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attend_plain_is_attend_ref(dtype):
    """The encoder's plain attention, scale and softmax written in place,
    computes ``attend_ref``'s bidirectional attention."""
    g = torch.Generator().manual_seed(4)
    q, k, v = (torch.randn((2, 37, 4, 16), generator=g).to(DT[dtype][1])
               for _ in range(3))
    a = tvlm.attend_plain(q, k, v)
    b = tattn.attend_ref(q, k, v, causal=False)
    tol = 1e-5 if dtype == "float32" else 1e-2
    np.testing.assert_allclose(_np(a), _np(b), rtol=tol, atol=tol)


def test_vision_encode_runs_on_the_card_unless_asked(vision_params,
                                                     monkeypatch):
    _, tp = vision_params["float32"]
    x = torch.zeros(1, 8, 64)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tvlm.vision_encode(tp, tvlm.VisionConfig(**SMALL), x, flash=True)


# ------------------------------------------------------------ Session
@pytest.fixture(scope="module")
def planning_dbs():
    out = {}
    for name in ("cli2", "h100"):
        tsys = SYSTEMS[name]
        jsys = JSystem(**dataclasses.asdict(tsys))
        out[name] = (jsys, jinstall.run_install(jsys, measure_cpu=False),
                     tsys, run_install(tsys, measure_cpu=False))
    return out


def _plain(obj):
    if dataclasses.is_dataclass(obj):
        return {f.name: _plain(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    if isinstance(obj, dict):
        return {k: _plain(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_plain(v) for v in obj]
    return obj


@pytest.mark.parametrize("system", ["cli2", "h100"])
def test_planning_only_vlm_session_matches_reference(planning_dbs, system):
    """qwen2-vl-7b at full width, as examples/vlm_budget.py plans it:
    schedule and estimates field for field at 4 and 8 GB; execution
    raises, naming the executor."""
    jsys, jdb, tsys, tdb = planning_dbs[system]
    jcfg, tcfg = jax_full(ARCH), torch_full(ARCH)
    for gb in (4.0, 8.0):
        js = repro.Session.open(jcfg, jsys, int(gb * 1e9),
                                JSetting(batch=1, context=4096), db=jdb)
        ts = Session.open(tcfg, tsys, int(gb * 1e9),
                          InferenceSetting(batch=1, context=4096), db=tdb,
                          device="cpu")
        assert _plain(ts.schedule) == _plain(js.schedule)
        assert [s.name for s in ts.subs] == [s.name for s in js.subs]
        assert ts.estimates(4096) == js.estimates(4096)
        assert ts.estimates() == js.estimates()
        with pytest.raises(NotImplementedError, match="executor"):
            ts.executor
        with pytest.raises(NotImplementedError, match="executor"):
            ts.generate(np.zeros((1, 4), np.int32))
