"""The port's audio (musicgen), hybrid (zamba2) and ssm (xLSTM) families
against the JAX package, on the CPU, at their smoke configs in f32 and
bf16.

- ``sinusoidal_positions`` and ``layernorm`` against the reference's;
- the param tree of the port's own init has the reference's keys, shapes
  and dtypes, and the numpy bridge carries the reference's tree bit for
  bit (the hybrid's ``groups`` / ``shared`` / ``tail``, the xLSTM's
  ``pairs``);
- the monolithic forward's logits, and ``prefill`` then ``decode_step``
  at every step (logits and the cache), against the reference's: f32
  within 2e-4, bf16 within 2e-2; greedy tokens under teacher forcing;
  the decoded logits against the no-cache forward's (as
  tests/test_models_smoke.py); the ``nn.Module`` wrappers equal to
  ``apply``;
- the planning-only ``Session`` at full width: graph, schedule bytes and
  estimates equal to the reference's, and execution raises;
- ``repro_torch.launch.serve`` on the CPU for one family and one dense
  arch; the entry points raise without a card unless asked for the CPU.

Inputs are made from seeds with numpy; the JAX package's weights reach
the port through the numpy param bridge.
"""
import contextlib
import dataclasses
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro
from repro.configs import get_config as jax_full
from repro.configs import get_smoke_config as jax_smoke
from repro.core import install as jinstall
from repro.core.system import InferenceSetting as JSetting
from repro.core.system import SystemConfig as JSystem
from repro.models import build_model as jax_build
from repro.models import common as jcommon
from repro_torch import Session
from repro_torch.configs import get_config as torch_full
from repro_torch.configs import get_smoke_config as torch_smoke
from repro_torch.core import SYSTEMS, InferenceSetting, run_install
from repro_torch.launch import serve
from repro_torch.models import build_model as torch_build
from repro_torch.models import common as tcommon
from repro_torch.models.api import params_from_numpy, tensor_from_numpy

torch.set_num_threads(1)

ARCHS = ("musicgen-medium", "zamba2-7b", "xlstm-125m")
DTYPES = ("float32", "bfloat16")
TOL = {"float32": dict(rtol=2e-4, atol=2e-4),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
# greedy tokens under teacher forcing: each port token is the
# reference's argmax up to this logit gap (bf16 near-ties)
TF_GAP = {"float32": 1e-4, "bfloat16": 6e-2}
B, PROMPT, STEPS = 2, 9, 4
S = PROMPT + STEPS + 3


def _np(x):
    if torch.is_tensor(x):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


@pytest.fixture(scope="module")
def models():
    """(arch, dtype) -> (jax cfg, port cfg, jax params, port params, the
    reference's jitted apply / prefill / decode_step)."""
    out = {}
    for arch in ARCHS:
        for dtype in DTYPES:
            jcfg = jax_smoke(arch).replace(dtype=dtype)
            tcfg = torch_smoke(arch).replace(dtype=dtype)
            jm = jax_build(jcfg)
            jp = jm.init(jax.random.PRNGKey(0))
            fns = (jax.jit(jm.apply), jax.jit(jm.prefill),
                   jax.jit(jm.decode_step))
            out[arch, dtype] = (jcfg, tcfg, jp,
                                params_from_numpy(jax.tree.map(np.asarray,
                                                               jp)), fns)
    return out


def _tokens(cfg, seed, T):
    shape = (B, T, cfg.n_codebooks) if cfg.n_codebooks else (B, T)
    return np.random.default_rng(seed).integers(0, cfg.vocab, shape) \
        .astype(np.int32)


def _jb(tok):
    return {"tokens": jnp.asarray(tok)}


def _tb(tok):
    return {"tokens": torch.from_numpy(np.ascontiguousarray(tok))}


def _tree_close(t, j, tol, path=()):
    if isinstance(j, dict):
        assert set(t) == set(j), path
        for k in j:
            _tree_close(t[k], j[k], tol, path + (k,))
        return
    assert tuple(t.shape) == tuple(j.shape), path
    assert str(t.dtype).split(".")[-1] == str(j.dtype), path
    np.testing.assert_allclose(_np(t), _np(j), err_msg=str(path), **tol)


# ------------------------------------------------------------ primitives
def test_sinusoidal_positions_match_reference():
    """XLA's and torch's f32 ``exp`` differ by one ulp in some of the
    frequencies (72 of 768 at d = 1536), so the angle p * f can differ by
    about p * 2^-23 x its size: positions under 64 are held to 2e-5, the
    rest up to 4200 (the chip's long runs) to 2 * 4200 * 2^-23."""
    for hi, atol in ((64, 2e-5), (4200, 2 * 4200 * 2.0 ** -23)):
        pos = np.arange(0, hi, 7, dtype=np.int32)[None, :].repeat(2, 0)
        for d in (64, 1536):
            ref = jcommon.sinusoidal_positions(jnp.asarray(pos), d)
            out = tcommon.sinusoidal_positions(torch.from_numpy(pos), d)
            assert out.dtype == torch.float32
            assert tuple(out.shape) == ref.shape
            np.testing.assert_allclose(_np(out), _np(ref), rtol=0,
                                       atol=atol)
    # the frequencies are the reference's f32 exp(-log(10000) i / half)
    one = tcommon.sinusoidal_positions(torch.ones(1, 1), 8)
    half = np.exp(-np.log(10000.0) * np.arange(4, dtype=np.float32) / 4)
    np.testing.assert_allclose(one[0, 0, :4].numpy(), np.sin(half),
                               rtol=1e-6)


@pytest.mark.parametrize("dtype", DTYPES)
def test_layernorm_matches_reference(dtype):
    rng = np.random.default_rng(1)
    jd = jnp.float32 if dtype == "float32" else jnp.bfloat16
    x, s, b = (jnp.asarray(rng.standard_normal(shape) * 3 + 1, jd)
               for shape in ((3, 5, 48), (48,), (48,)))
    ref = jcommon.layernorm(x, s, b, 1e-5)
    out = tcommon.layernorm(*(tensor_from_numpy(np.asarray(v))
                              for v in (x, s, b)), 1e-5)
    assert out.dtype == tensor_from_numpy(np.asarray(x)).dtype
    np.testing.assert_allclose(_np(out), _np(ref), **TOL[dtype])


# ------------------------------------------------------------ params
@pytest.mark.parametrize("arch", ARCHS)
def test_own_init_and_bridge_equal_the_reference_tree(models, arch):
    for dtype in DTYPES:
        jcfg, tcfg, jp, tp, _ = models[arch, dtype]
        jl = jax.tree_util.tree_leaves_with_path(jp)
        assert len(jl) == len(tcommon.tree_leaves(tp))
        for path, leaf in jl:
            t = tp
            for k in path:
                t = t[k.key]
            assert torch.equal(t, tensor_from_numpy(np.asarray(leaf))), path
        own = torch_build(tcfg).init(torch.Generator().manual_seed(0))

        def spec(tree):
            return tcommon.tree_map(lambda t: (tuple(t.shape), t.dtype),
                                    tree)
        assert spec(own) == spec(tp)


# ------------------------------------------------------------ forward
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_match(models, arch, dtype):
    jcfg, tcfg, jp, tp, (japply, _, _) = models[arch, dtype]
    tok = _tokens(jcfg, 2, 13)
    jl, _ = japply(jp, _jb(tok))
    tl, cache = torch_build(tcfg).apply(tp, _tb(tok))
    assert cache is None
    V = jcfg.vocab
    want = (B, 13, jcfg.n_codebooks, V) if jcfg.n_codebooks else (B, 13, V)
    assert tuple(tl.shape) == want == jl.shape
    assert tl.dtype == tcommon.dtype_of(tcfg)
    np.testing.assert_allclose(_np(tl), _np(jl), **TOL[dtype])
    # the family's nn.Module computes the same logits
    ml, _ = torch_build(tcfg).module(tp)(torch.from_numpy(tok))
    assert torch.equal(ml, tl)


def _rel_gap(out, ref):
    """max |out - ref| / max |ref|."""
    a, b = _np(out), _np(ref)
    return np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-9)


def _caches(jm, tm, dtype):
    """The reference's and the port's caches. An f32 model gets f32 KV
    caches here (the default is bf16 for every model, and in both
    packages): rounding k and v to bf16 turns f32 differences of 1e-6 in
    front of the hybrid's first attention into bf16 ulps, 2e-4 in its
    output, so the tight f32 comparison holds the math with f32 caches;
    bf16 runs with the default caches."""
    if dtype == "bfloat16" or jm.cfg.family == "ssm":
        return jm.init_cache(B, S), tm.init_cache(B, S, device="cpu")
    return (jm.module.init_cache(jm.cfg, B, S, dtype=jnp.float32),
            tm.impl.init_cache(tm.cfg, B, S, dtype=torch.float32,
                               device="cpu"))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_steps_match(models, arch, dtype):
    """Model.prefill, then STEPS greedy decode_steps fed the port's own
    tokens. At every step, one port step from the reference's cache gives
    the reference's logits and cache; in f32 the port's own run does too.
    A bf16 decode step is held as the reference holds its own decode
    against its forward (tests/test_models_smoke.py): max |diff| within
    5% of max |logit|. At two rows a bf16 matmul's f32 sum order can
    round one element of the (B, 1, d) products to the neighbouring bf16
    value, and zamba2's seven bf16 layers carry such a flip to 0.05 of
    logits of scale 2 within one step. The port's own bf16 run is held
    by its tokens under teacher forcing against the reference's forward.
    The last decoded logits are held against the port's forward."""
    jcfg, tcfg, jp, tp, (japply, jprefill, jdecode) = models[arch, dtype]
    jm, tm = jax_build(jcfg), torch_build(tcfg)
    tok = _tokens(jcfg, 3, PROMPT)
    jc, tc = _caches(jm, tm, dtype)
    jlast, jc = jprefill(jp, _jb(tok), jc)
    tlast, tc2 = tm.prefill(tp, _tb(tok), tc)
    assert tc2 is tc                       # written in place
    np.testing.assert_allclose(_np(tlast), _np(jlast), **TOL[dtype])
    _tree_close(tc, jc, TOL[dtype])
    seq = [tok]
    for s in range(STEPS):
        nxt = tcommon.greedy_token(tlast[:, -1]).numpy()[:, None]
        seq.append(nxt)
        pos = PROMPT + s
        synced = params_from_numpy(jax.tree.map(np.asarray, jc))
        jd, jc = jdecode(jp, _jb(nxt), jc, jnp.int32(pos))
        sd, _ = tm.decode_step(tp, _tb(nxt), synced, pos)
        if dtype == "float32":
            np.testing.assert_allclose(_np(sd), _np(jd), **TOL[dtype])
            _tree_close(synced, jc, TOL[dtype])
        else:
            assert _rel_gap(sd, jd) < 0.05, (s, _rel_gap(sd, jd))
            for path, leaf in jax.tree_util.tree_leaves_with_path(jc):
                t = synced
                for k in path:
                    t = t[k.key]
                assert _rel_gap(t, leaf) < 0.05, (s, path)
        tlast, _ = tm.decode_step(tp, _tb(nxt), tc, pos)
        if dtype == "float32":
            np.testing.assert_allclose(_np(tlast), _np(jd), **TOL[dtype])
            _tree_close(tc, jc, TOL[dtype])
    full = np.concatenate(seq, axis=1)
    # teacher forcing: every token the port picked is the reference
    # forward's argmax at its position within TF_GAP
    jl = _np(japply(jp, _jb(full))[0])
    picked = full[:, PROMPT:]
    z = jl[:, PROMPT - 1:-1]
    gap = z.max(-1) - np.take_along_axis(z, picked[..., None], -1)[..., 0]
    assert gap.max() <= TF_GAP[dtype], gap.max()
    # decode == the no-cache forward at the last position (the check of
    # tests/test_models_smoke.py)
    tl, _ = tm.apply(tp, _tb(full))
    assert _rel_gap(tlast[:, -1], tl[:, -1]) < 0.05


def test_hybrid_f32_conv_history_follows_the_model_dtype(models):
    """The reference's f32 model carries its conv history in f32 after
    the first write (bf16 zeros concatenated with f32 inputs); the port's
    cache does the same, in the same dict."""
    _, tcfg, _, tp, _ = models["zamba2-7b", "float32"]
    tm = torch_build(tcfg)
    cache = tm.init_cache(B, S, device="cpu")
    assert cache["groups"]["conv"].dtype == torch.bfloat16
    _, out = tm.prefill(tp, _tb(_tokens(tcfg, 4, 5)), cache)
    assert out is cache
    assert cache["groups"]["conv"].dtype == torch.float32
    assert cache["tail"]["conv"].dtype == torch.float32


@pytest.mark.parametrize("arch", ARCHS)
def test_entry_points_run_on_the_card_unless_asked(models, arch,
                                                   monkeypatch):
    _, tcfg, _, _, _ = models[arch, "float32"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        torch_build(tcfg).init_cache(1, 8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Session.open(tcfg, "h100", 1 << 30)


# ------------------------------------------------------------ Session
@pytest.fixture(scope="module")
def h100_dbs():
    tsys = SYSTEMS["h100"]
    jsys = JSystem(**dataclasses.asdict(tsys))
    return (jsys, jinstall.run_install(jsys, measure_cpu=False), tsys,
            run_install(tsys, measure_cpu=False))


def _plain(obj):
    if dataclasses.is_dataclass(obj):
        return {f.name: _plain(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    if isinstance(obj, dict):
        return {k: _plain(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_plain(v) for v in obj]
    return obj


@pytest.mark.parametrize("arch", ARCHS)
def test_planning_only_session_matches_reference(h100_dbs, arch):
    """The full config on the h100 figures at 0.5x its weight bytes:
    graph, schedule and estimates equal to the reference's; execution
    raises, naming the executor."""
    jsys, jdb, tsys, tdb = h100_dbs
    jcfg, tcfg = jax_full(arch), torch_full(arch)
    ts = Session.open(tcfg, tsys, 1, InferenceSetting(batch=4,
                                                      context=4096),
                      db=tdb, device="cpu")
    budget = sum(s.weight_bytes for s in ts.subs) // 2
    js = repro.Session.open(jcfg, jsys, budget,
                            JSetting(batch=4, context=4096), db=jdb)
    ts = Session.open(tcfg, tsys, budget,
                      InferenceSetting(batch=4, context=4096), db=tdb,
                      device="cpu")
    assert _plain(ts.subs) == _plain(js.subs)
    assert _plain(ts.schedule) == _plain(js.schedule)
    assert (ts.schedule.pinned_bytes, ts.schedule.scratch_bytes,
            ts.schedule.kv_pool_bytes) == (js.schedule.pinned_bytes,
                                           js.schedule.scratch_bytes,
                                           js.schedule.kv_pool_bytes)
    for isl in (None, 64, 4096):
        assert ts.estimates(isl) == js.estimates(isl)
    with pytest.raises(NotImplementedError, match="executor"):
        ts.executor
    with pytest.raises(NotImplementedError, match="executor"):
        ts.generate(np.zeros((1, 4), np.int32))


# ------------------------------------------------------------ launcher
@pytest.mark.parametrize("arch,executes", [("zamba2-7b", False),
                                           ("qwen2-0.5b", True)])
def test_launch_serve_main_on_the_cpu(arch, executes):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        serve.main(["--arch", arch, "--device", "cpu", "--batch", "2",
                    "--new-tokens", "3", "--prompt-len", "6"])
    text = out.getvalue()
    assert f"[serve] {arch} (" in text and "est TTFT(4096)" in text
    assert "decode : tier" in text and "prefill: tier" in text
    if executes:
        assert "smoke-scale serving: 2 requests x 3 tokens" in text
        assert "serving continued" in text
    else:
        assert "planning-only for family hybrid" in text


def _serve_ref(jm, jp, tok, steps, cache):
    """The reference's greedy serve: prefill, then ``steps`` decode steps;
    (tokens (B, steps + 1), the decode steps' logits)."""
    P = tok.shape[1]
    last, cache = jax.jit(jm.prefill)(jp, _jb(tok), cache)
    logits = [_np(last[:, -1])]
    dec = jax.jit(jm.decode_step)
    for s in range(steps):
        nxt = logits[-1].argmax(-1).astype(np.int32)[:, None]
        lg, cache = dec(jp, _jb(nxt), cache, jnp.int32(P + s))
        logits.append(_np(lg[:, -1]))
    return np.stack([z.argmax(-1) for z in logits], 1), np.stack(logits, 1)


def _forward_gap(apply, tok, gen):
    """The teacher-forced gap of ``gen`` against ``apply``'s forward over
    the prompt and the generated tokens."""
    P = tok.shape[1]
    z = _np(apply(np.concatenate([tok, gen[:, :-1]], 1).astype(np.int32)))
    z = z[:, P - 1:]
    return (z.max(-1) - np.take_along_axis(z, gen[..., None], -1)[..., 0]) \
        .max()


def test_zamba2_full_depth_drift():
    """zamba2 at its 81 layers (d = 256, narrow): the reference's own bf16
    served tokens depart from its own forward by more than the 0.25 that
    the chip's teacher forcing allows (one rounding flip of the stepped
    SSD against the chunked one, carried through 81 bf16 layers), so
    phase 16 of chip_smoke.py gates zamba2's served tokens in f32. In
    f32 with f32 KV caches the port's served tokens equal the
    reference's, its logits agree within 1e-3, and its tokens stay within
    1e-2 of the port's forward."""
    from repro_torch.models import hybrid as thybrid
    kw = dict(d_model=256, n_heads=4, n_kv_heads=4, head_dim=64, d_ff=512,
              vocab=4096)
    B_, P, N = 2, 64, 8
    tok = np.random.default_rng(0).integers(0, 4096, (B_, P)) \
        .astype(np.int32)
    jcfg = jax_full("zamba2-7b").replace(**kw)
    jm = jax_build(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    jgen, _ = _serve_ref(jm, jp, tok, N - 1, jm.init_cache(B_, P + N))
    japply = jax.jit(jm.apply)
    ref_gap = _forward_gap(lambda t: japply(jp, _jb(t))[0], tok, jgen)
    print(f"reference bf16 gap {ref_gap}")
    assert ref_gap > 0.25
    # f32: the same weights, f32 KV caches in both packages
    jcfg = jcfg.replace(dtype="float32")
    jm = jax_build(jcfg)
    jp = jax.tree.map(lambda a: a.astype(jnp.float32), jp)
    jgen, jlog = _serve_ref(jm, jp, tok, N - 1, jm.module.init_cache(
        jcfg, B_, P + N, dtype=jnp.float32))
    tcfg = torch_full("zamba2-7b").replace(dtype="float32", **kw)
    tm, tp = torch_build(tcfg), params_from_numpy(jax.tree.map(np.asarray,
                                                               jp))
    cache = thybrid.init_cache(tcfg, B_, P + N, dtype=torch.float32,
                               device="cpu")
    last, cache = tm.prefill(tp, _tb(tok), cache)
    logits = [last[:, -1]]
    for s in range(N - 1):
        nxt = tcommon.greedy_token(logits[-1])[:, None]
        lg, cache = tm.decode_step(tp, {"tokens": nxt}, cache, P + s)
        logits.append(lg[:, -1])
    tlog = torch.stack(logits, 1)
    tgen = tcommon.greedy_token(tlog).numpy()
    assert np.array_equal(tgen, jgen)
    # 81 layers carry f32 sum-order differences (~1e-7) to ~4e-4 here
    np.testing.assert_allclose(_np(tlog), jlog, rtol=1e-3, atol=1e-3)
    gap = _forward_gap(lambda t: tm.apply(tp, _tb(t))[0], tok, tgen)
    print(f"port f32 gap {gap}")
    assert gap <= 1e-2
