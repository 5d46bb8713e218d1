"""Each ported engine step against the JAX package's jitted step.

The same numpy-seeded weights (through the param bridge), activations and
KV stacks go into ``repro.core.engine.SubLayerEngine`` and into the port's
step functions on the CPU. fp32 compares the algorithm (tight: only the
order of sums differs); bf16 uses the kernel tests' 2e-2. The KV stacks
are bf16 in both packages and are compared at that tolerance as well.
The streamed FFN is also held against the reference's Pallas
``streamed_matmul`` run in interpret mode, which the smoke widths tile.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.core.engine import SubLayerEngine
from repro.models import build_model as jax_build
from repro_torch.configs import get_smoke_config as torch_smoke
from repro_torch.core import engine as teng
from repro_torch.models.api import params_from_numpy, tensor_from_numpy
from repro_torch.models.transformer import layer_slice

torch.set_num_threads(1)

TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
KV_TOL = dict(rtol=2e-2, atol=2e-2)
B, S, LAYER = 2, 16, 1


def _np(x):
    if torch.is_tensor(x):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(x, np.float32)


def _t(a):
    return tensor_from_numpy(np.asarray(a))


class Case:
    """One config in one dtype: both packages' weights for layer LAYER, the
    reference engine, and seeded inputs."""

    def __init__(self, arch, dtype):
        self.arch, self.dtype = arch, dtype
        self.jcfg = jax_smoke(arch).replace(dtype=dtype)
        self.tcfg = torch_smoke(arch).replace(dtype=dtype)
        jp = jax_build(self.jcfg).init(jax.random.PRNGKey(0))
        tp = params_from_numpy(jax.tree.map(np.asarray, jp))
        lj = jax.tree.map(lambda a: a[LAYER], jp["layers"])
        lt = layer_slice(tp["layers"], LAYER)
        self.w = {"attn": ({"attn": lj["attn"], "ln1": lj["ln1"]},
                           {"attn": lt["attn"], "ln1": lt["ln1"]}),
                  "ffn": ({"ffn": lj["ffn"], "ln2": lj["ln2"]},
                          {"ffn": lt["ffn"], "ln2": lt["ln2"]})}
        self.ends = ((jp["embed"], jp["final_norm"]),
                     (tp["embed"], tp["final_norm"]))
        self.eng = SubLayerEngine(self.jcfg)
        self.rng = np.random.default_rng(0)

    def x(self, T):
        a = self.rng.standard_normal((B, T, self.jcfg.d_model))
        a = a.astype(np.float32)
        return jnp.asarray(a, self.dtype), _t(jnp.asarray(a, self.dtype))

    def kv(self, filled):
        """Stacked bf16 caches, random below ``filled`` and zero above."""
        cfg = self.jcfg
        shape = (cfg.n_layers, B, cfg.n_kv_heads, S, cfg.resolved_head_dim)
        out = []
        for _ in range(2):
            a = self.rng.standard_normal(shape).astype(np.float32)
            a[:, :, :, filled:] = 0.0
            j = jnp.asarray(a, jnp.bfloat16)
            out.append((j, _t(j)))
        return out


@pytest.fixture(scope="module", params=[
    ("qwen2-0.5b", "float32"), ("qwen2-0.5b", "bfloat16"),
    ("qwen3-14b", "float32"), ("qwen3-14b", "bfloat16")],
    ids=lambda p: f"{p[0]}-{p[1]}")
def case(request):
    return Case(*request.param)


def _check(case, out_t, out_j, kv_t=(), kv_j=()):
    np.testing.assert_allclose(_np(out_t), _np(out_j), **TOL[case.dtype])
    for a, b in zip(kv_t, kv_j):
        np.testing.assert_allclose(_np(a), _np(b), **KV_TOL)


def test_attn_step(case):
    wj, wt = case.w["attn"]
    xj, xt = case.x(3)
    (kj, kt), (vj, vt) = case.kv(filled=5)
    oj, kj, vj = case.eng.attn_step(wj, xj, kj, vj, jnp.int32(LAYER),
                                    jnp.int32(5))
    ot = teng.attn_step(case.tcfg, wt, xt, kt, vt, LAYER, 5)
    _check(case, ot, oj, (kt, vt), (kj, vj))


@pytest.mark.parametrize("pos,valid", [(0, 4), (4, 2), (14, 2)])
def test_attn_prefill_step_masks_padded_tail(case, pos, valid):
    """valid < T: the padded positions never land in the cache. At pos=14
    the 4-wide window is clamped to start at 12 in both packages."""
    wj, wt = case.w["attn"]
    xj, xt = case.x(4)
    (kj, kt), (vj, vt) = case.kv(filled=pos)
    oj, kj, vj = case.eng.attn_prefill_step(
        wj, xj, kj, vj, jnp.int32(LAYER), jnp.int32(pos), jnp.int32(valid))
    ot = teng.attn_prefill_step(case.tcfg, wt, xt, kt, vt, LAYER, pos, valid)
    _check(case, ot, oj, (kt, vt), (kj, vj))
    if pos + 4 <= S:
        assert not kt[LAYER, :, :, pos + valid:].any()


def test_attn_prefill_slot_step(case):
    wj, wt = case.w["attn"]
    xj, xt = case.x(4)
    xj, xt = xj[1:], xt[1:]                   # one admitted sequence
    (kj, kt), (vj, vt) = case.kv(filled=0)
    before = kt.clone()
    oj, kj, vj = case.eng.attn_prefill_slot_step(
        wj, xj, kj, vj, jnp.int32(LAYER), jnp.int32(1), jnp.int32(0),
        jnp.int32(3))
    ot = teng.attn_prefill_slot_step(case.tcfg, wt, xt, kt, vt, LAYER, 1,
                                     0, 3)
    _check(case, ot, oj, (kt, vt), (kj, vj))
    assert torch.equal(kt[:, 0], before[:, 0])    # other slot untouched


def test_attn_decode_step(case):
    wj, wt = case.w["attn"]
    xj, xt = case.x(1)
    (kj, kt), (vj, vt) = case.kv(filled=6)
    pos = np.array([6, 3], np.int32)
    for active in (np.array([True, True]), np.array([False, True])):
        kj2, vj2, kt2, vt2 = kj, vj, kt.clone(), vt.clone()
        oj, kj2, vj2 = case.eng.attn_decode_step(
            wj, xj, kj2, vj2, jnp.int32(LAYER), jnp.asarray(pos),
            jnp.asarray(active))
        ot = teng.attn_decode_step(case.tcfg, wt, xt, kt2, vt2, LAYER,
                                   torch.from_numpy(pos),
                                   torch.from_numpy(active))
        _check(case, ot, oj, (kt2, vt2), (kj2, vj2))
        if not active[0]:
            assert torch.equal(kt2[:, 0], kt[:, 0])


@pytest.mark.parametrize("T", [1, 4])
def test_ffn_step_matches_pinned_and_pallas(case, T):
    wj, wt = case.w["ffn"]
    xj, xt = case.x(T)
    ot = teng.ffn_step(case.tcfg, wt, xt)
    _check(case, ot, case.eng.ffn_step(wj, xj, streamed=False))
    # the Pallas blocks tile qwen2-0.5b's smoke widths (d=56, f=112) only
    pallas = SubLayerEngine(case.jcfg, use_streamed_mm=True)
    if case.arch == "qwen2-0.5b":
        assert pallas._streamed_mm_ok(xj.shape, wj["ffn"])
        _check(case, ot, pallas.ffn_step(wj, xj, streamed=True))


def test_embed_and_head_steps(case):
    (ej, fj), (et, ft) = case.ends
    tok = case.rng.integers(0, case.jcfg.vocab, (B, 5)).astype(np.int32)
    xj = case.eng.embed_step(ej, jnp.asarray(tok))
    xt = teng.embed_step(et, torch.from_numpy(tok))
    assert np.array_equal(_np(xt), _np(xj))      # a gather: bit for bit
    _check(case, teng.head_step(case.tcfg, ft, et.T, xt),
           case.eng.head_step(fj, ej.T, xj))
