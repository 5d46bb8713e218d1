"""The PyTorch port's model math against the JAX reference, on the CPU.

Inputs are made from a seed with numpy and handed to both packages; the
JAX package's parameters reach the port through the numpy param bridge.
Tolerances: fp32 compares the algorithm (tight: only the order of sums
differs), bf16 uses the kernel tests' 2e-2 (bf16 rounds at other places in
XLA and torch).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.models import attention as jattn
from repro.models import build_model as jax_build
from repro.models import common as jcommon
from repro_torch.configs import get_smoke_config as torch_smoke
from repro_torch.models import attention as tattn
from repro_torch.models import build_model as torch_build
from repro_torch.models import common as tcommon
from repro_torch.models.api import params_from_numpy, tensor_from_numpy

torch.set_num_threads(1)

ARCHS = ["qwen2-0.5b", "qwen3-14b"]   # qkv_bias / qk_norm
TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}


def _np(x):
    return np.asarray(x, np.float32) if not torch.is_tensor(x) \
        else x.detach().to(torch.float32).numpy()


def _pair(cfg_name, dtype):
    jcfg = jax_smoke(cfg_name).replace(dtype=dtype)
    tcfg = torch_smoke(cfg_name).replace(dtype=dtype)
    jp = jax_build(jcfg).init(jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp))
    return jcfg, tcfg, jp, tp


@pytest.fixture(scope="module")
def models():
    return {(a, d): _pair(a, d) for a in ARCHS
            for d in ("float32", "bfloat16")}


# ------------------------------------------------------------ bridge
@pytest.mark.parametrize("arch", ARCHS)
def test_param_bridge_bit_exact(models, arch):
    jcfg, tcfg, jp, tp = models[(arch, "bfloat16")]
    jl = jax.tree_util.tree_leaves_with_path(jp)
    assert len(jl) == len(tcommon.tree_leaves(tp))
    for path, leaf in jl:
        t = tp
        for k in path:
            t = t[k.key]
        a = np.asarray(leaf)
        assert tuple(t.shape) == a.shape
        assert t.dtype == torch.bfloat16
        assert np.array_equal(t.view(torch.int16).numpy(),
                              a.view(np.int16))


def test_bridge_copies_read_only_arrays():
    a = np.asarray(jnp.arange(6, dtype=jnp.float32))
    assert not a.flags.writeable
    t = tensor_from_numpy(a)
    t += 1                        # owns writable memory
    assert np.array_equal(a, np.arange(6, dtype=np.float32))


# ------------------------------------------------------------ primitives
def test_rmsnorm_rope_greedy_match():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 3, 16)).astype(np.float32)
    s = rng.standard_normal((16,)).astype(np.float32)
    pos = rng.integers(0, 300, size=(2, 5)).astype(np.int32)
    np.testing.assert_allclose(
        _np(tcommon.rmsnorm(torch.from_numpy(x), torch.from_numpy(s), 1e-6)),
        _np(jcommon.rmsnorm(jnp.asarray(x), jnp.asarray(s), 1e-6)),
        rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        _np(tcommon.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                               1e6)),
        _np(jcommon.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6)),
        rtol=1e-5, atol=1e-5)
    # ties break toward the lowest index in both, after the f32 upcast
    logits = np.array([[1.0, 3.0, 3.0, -2.0], [0.5, 0.5, 0.5, 0.5]],
                      np.float32)
    assert np.array_equal(
        tcommon.greedy_token(torch.from_numpy(logits)).numpy(),
        np.asarray(jcommon.greedy_token(jnp.asarray(logits))))


def _qkv(rng, B, T, H, KV, S, hd):
    q = rng.standard_normal((B, T, H, hd)).astype(np.float32)
    ck = rng.standard_normal((B, KV, S, hd)).astype(np.float32)
    cv = rng.standard_normal((B, KV, S, hd)).astype(np.float32)
    return q, ck, cv


@pytest.mark.parametrize("T,pos", [(4, 0), (4, 9), (3, 13)])
def test_attend_cached_matches(T, pos):
    rng = np.random.default_rng(T + pos)
    q, ck, cv = _qkv(rng, 2, T, 6, 2, 16, 8)
    out = tattn.attend_cached(torch.from_numpy(q), torch.from_numpy(ck),
                              torch.from_numpy(cv), pos)
    ref = jattn.attend_cached(jnp.asarray(q), jnp.asarray(ck),
                              jnp.asarray(cv), pos)
    np.testing.assert_allclose(_np(out), _np(ref), **TOL["float32"])


def test_attend_decode_scalar_and_vector_positions():
    rng = np.random.default_rng(1)
    q, ck, cv = _qkv(rng, 3, 1, 4, 2, 12, 8)
    for pos in (5, np.array([0, 7, 11], np.int32)):
        tpos = pos if np.isscalar(pos) else torch.from_numpy(pos)
        out = tattn.attend_decode(torch.from_numpy(q), torch.from_numpy(ck),
                                  torch.from_numpy(cv), tpos)
        ref = jattn.attend_decode(jnp.asarray(q), jnp.asarray(ck),
                                  jnp.asarray(cv), jnp.asarray(pos))
        np.testing.assert_allclose(_np(out), _np(ref), **TOL["float32"])


@pytest.mark.parametrize("pos", [0, 5, 7, 20])   # 7, 20: start clamps
def test_cache_update_matches_including_clamp(pos):
    """jax.lax.dynamic_update_slice clamps the write start so the whole
    update fits; the port reproduces the clamp (3 tokens at 7 of 8 land at
    5..7)."""
    rng = np.random.default_rng(pos)
    ck = rng.standard_normal((2, 1, 8, 4)).astype(np.float32)
    cv = rng.standard_normal((2, 1, 8, 4)).astype(np.float32)
    k = rng.standard_normal((2, 3, 1, 4)).astype(np.float32)
    v = rng.standard_normal((2, 3, 1, 4)).astype(np.float32)
    tk, tv = tattn.cache_update(torch.from_numpy(ck.copy()),
                                torch.from_numpy(cv.copy()),
                                torch.from_numpy(k), torch.from_numpy(v), pos)
    jk, jv = jattn.cache_update(jnp.asarray(ck), jnp.asarray(cv),
                                jnp.asarray(k), jnp.asarray(v), pos)
    assert np.array_equal(tk.numpy(), np.asarray(jk))
    assert np.array_equal(tv.numpy(), np.asarray(jv))
    if pos >= 5:
        assert np.array_equal(tk.numpy()[:, 0, 5:], k[:, :, 0])


def test_cache_update_ones_at_seven_land_at_five():
    cache = torch.zeros((1, 1, 8, 1))
    ones = torch.ones((1, 3, 1, 1))
    tattn.cache_update(cache, cache.clone(), ones, ones, 7)
    assert cache.flatten().tolist() == [0, 0, 0, 0, 0, 1, 1, 1]


def test_cache_update_batched_matches_including_clamp():
    rng = np.random.default_rng(3)
    ck = rng.standard_normal((3, 2, 8, 4)).astype(np.float32)
    cv = rng.standard_normal((3, 2, 8, 4)).astype(np.float32)
    k = rng.standard_normal((3, 2, 2, 4)).astype(np.float32)
    v = rng.standard_normal((3, 2, 2, 4)).astype(np.float32)
    pos = np.array([0, 3, 7], np.int32)          # row 2 clamps to 6
    tk, tv = tattn.cache_update_batched(
        torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy()),
        torch.from_numpy(k), torch.from_numpy(v), torch.from_numpy(pos))
    jk, jv = jattn.cache_update_batched(jnp.asarray(ck), jnp.asarray(cv),
                                        jnp.asarray(k), jnp.asarray(v),
                                        jnp.asarray(pos))
    assert np.array_equal(tk.numpy(), np.asarray(jk))
    assert np.array_equal(tv.numpy(), np.asarray(jv))
    # inactive rows keep their contents
    active = torch.tensor([True, False, True])
    tk2, _ = tattn.cache_update_batched(
        torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy()),
        torch.from_numpy(k), torch.from_numpy(v), torch.from_numpy(pos),
        active=active)
    assert np.array_equal(tk2.numpy()[1], ck[1])
    assert np.array_equal(tk2.numpy()[2], np.asarray(jk)[2])


# ------------------------------------------------------------ monolithic
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_monolithic_logits_match(models, arch, dtype):
    jcfg, tcfg, jp, tp = models[(arch, dtype)]
    tokens = np.random.default_rng(7).integers(0, jcfg.vocab, (2, 11)) \
        .astype(np.int32)
    jl, _ = jax_build(jcfg).apply(jp, {"tokens": jnp.asarray(tokens)})
    tl, _ = torch_build(tcfg).apply(tp, {"tokens": torch.from_numpy(tokens)})
    np.testing.assert_allclose(_np(tl), _np(jl), **TOL[dtype])
    # the nn.Module holds the same tree and computes the same logits
    ml, _ = torch_build(tcfg).module(tp)(torch.from_numpy(tokens))
    assert torch.equal(ml, tl)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_monolithic_cached_prefill_and_decode_match(models, arch, dtype):
    jcfg, tcfg, jp, tp = models[(arch, dtype)]
    tokens = np.random.default_rng(8).integers(0, jcfg.vocab, (2, 9)) \
        .astype(np.int32)
    jm, tm = jax_build(jcfg), torch_build(tcfg)
    jc = jm.init_cache(2, 16)
    tc = tm.init_cache(2, 16, device="cpu")
    jl, jc = jm.apply(jp, {"tokens": jnp.asarray(tokens[:, :8])}, cache=jc,
                      cache_pos=0)
    tl, tc = tm.apply(tp, {"tokens": torch.from_numpy(tokens[:, :8])},
                      cache=tc, cache_pos=0)
    np.testing.assert_allclose(_np(tl), _np(jl), **TOL[dtype])
    jl, jc = jm.apply(jp, {"tokens": jnp.asarray(tokens[:, 8:])}, cache=jc,
                      cache_pos=8)
    tl, tc = tm.apply(tp, {"tokens": torch.from_numpy(tokens[:, 8:])},
                      cache=tc, cache_pos=8)
    np.testing.assert_allclose(_np(tl), _np(jl), **TOL[dtype])
    np.testing.assert_allclose(_np(tc["k"]), _np(jc["k"]), **TOL["bfloat16"])


def test_init_cache_without_cuda_raises(monkeypatch):
    """The caches go on the card unless device="cpu" is passed; with no
    CUDA the call raises instead of placing them on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tm = torch_build(torch_smoke("qwen2-0.5b"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tm.init_cache(2, 16)
    assert tm.init_cache(2, 16, device="cpu")["k"].device.type == "cpu"


def test_rope_freqs_cached_per_device():
    """apply_rope copies its frequencies to the device once, bit-equal to
    the reference's numpy values."""
    x = torch.from_numpy(np.random.default_rng(9).standard_normal(
        (1, 3, 2, 16)).astype(np.float32))
    pos = torch.arange(3)[None, :]
    a = tcommon.apply_rope(x, pos, 10000.0)
    f = tcommon._FREQS[(16, 10000.0, x.device)]
    assert np.array_equal(f.numpy(), jcommon.rope_freqs(16, 10000.0))
    b = tcommon.apply_rope(x, pos, 10000.0)
    assert tcommon._FREQS[(16, 10000.0, x.device)] is f
    assert torch.equal(a, b)
