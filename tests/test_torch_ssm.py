"""The port's state-space blocks against the JAX package, on the CPU.

- ``segsum``'s semantics and values;
- ``ssd`` with shared and per-head b/c, with and without an initial state,
  against the reference and against a sequential f64 recurrence (as
  tests/test_ssm.py), within the reference's own 2e-4; its chunk
  assertion kept;
- ``ssd_step`` continuing an ``ssd`` state;
- ``causal_conv`` whole and streamed one step at a time, bit-equal to the
  reference in bf16 and f32; its new state never aliases the old;
- ``mamba_block`` (zamba2 smoke widths), ``mlstm_block`` and
  ``slstm_block`` (xlstm smoke widths), each without a state and with a
  carried state (a chunk, then one step), against the reference: f32
  within 2e-4, bf16 within 2e-2.

Inputs are made from seeds with numpy and handed to both packages; the
blocks' weights are the reference's, through the numpy param bridge.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.models import ssm as jssm
from repro_torch.models import ssm as tssm
from repro_torch.models.api import params_from_numpy, tensor_from_numpy

torch.set_num_threads(1)

TOL = {"float32": dict(rtol=2e-4, atol=2e-4),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
DT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _np(x):
    if torch.is_tensor(x):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _pair(a, dtype="float32"):
    """One numpy array as (jax array, torch tensor) of ``dtype``, the
    same bits."""
    j = jnp.asarray(a, DT[dtype])
    return j, tensor_from_numpy(np.asarray(j))


def _bits_equal(t, j):
    return torch.equal(t, tensor_from_numpy(np.asarray(j)))


def naive_ssd(x, a, b, c, state=None):
    """Sequential reference in f64: S_t = exp(a_t) S_{t-1} + x_t b_t^T;
    y_t = S_t c_t."""
    x, a, b, c = (np.asarray(_np(v), np.float64) for v in (x, a, b, c))
    B_, T, H, P = x.shape
    per_head = b.ndim == 4
    S = np.zeros((B_, H, P, b.shape[-1])) if state is None else \
        np.asarray(_np(state), np.float64).copy()
    ys = np.zeros((B_, T, H, P))
    for t in range(T):
        for h in range(H):
            bt = b[:, t, h] if per_head else b[:, t]
            ct = c[:, t, h] if per_head else c[:, t]
            S[:, h] = np.exp(a[:, t, h])[:, None, None] * S[:, h] \
                + np.einsum("bp,bn->bpn", x[:, t, h], bt)
            ys[:, t, h] = np.einsum("bpn,bn->bp", S[:, h], ct)
    return ys, S


def _ssd_inputs(seed, B_, T, H, P, N, per_head):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B_, T, H, P)) * 0.5
    a = -np.abs(rng.standard_normal((B_, T, H))) * 0.3
    bshape = (B_, T, H, N) if per_head else (B_, T, N)
    b = rng.standard_normal(bshape) * 0.5
    c = rng.standard_normal(bshape) * 0.5
    return [v.astype(np.float32) for v in (x, a, b, c)]


# ------------------------------------------------------------ SSD core
def test_segsum_semantics_and_values():
    s = tssm.segsum(torch.tensor([1.0, 2.0, 3.0]))
    assert s[0, 0] == 0.0 and s[1, 0] == 2.0 and s[2, 0] == 5.0
    assert s[2, 1] == 3.0 and torch.isneginf(s[0, 2])
    x = np.random.default_rng(0).standard_normal((2, 3, 9)) \
        .astype(np.float32)
    np.testing.assert_allclose(_np(tssm.segsum(torch.from_numpy(x))),
                               _np(jssm.segsum(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("per_head", [False, True])
@pytest.mark.parametrize("chunk,T", [(16, 64), (256, 512), (256, 40)])
def test_ssd_matches_reference_and_sequential(per_head, chunk, T):
    B_, H, P, N = 2, 3, 8, 4
    x, a, b, c = _ssd_inputs(1, B_, T, H, P, N, per_head)
    y, S = tssm.ssd(*(torch.from_numpy(v) for v in (x, a, b, c)),
                    chunk=chunk)
    jy, jS = jssm.ssd(*(jnp.asarray(v) for v in (x, a, b, c)), chunk=chunk)
    assert y.dtype == torch.float32 and S.dtype == torch.float32
    np.testing.assert_allclose(_np(y), _np(jy), **TOL["float32"])
    np.testing.assert_allclose(_np(S), _np(jS), **TOL["float32"])
    y_ref, S_ref = naive_ssd(x, a, b, c)
    np.testing.assert_allclose(_np(y), y_ref, **TOL["float32"])
    np.testing.assert_allclose(_np(S), S_ref, **TOL["float32"])


@pytest.mark.parametrize("per_head", [False, True])
def test_ssd_from_an_initial_state(per_head):
    B_, T, H, P, N = 1, 32, 2, 5, 4
    x, a, b, c = _ssd_inputs(2, B_, 2 * T, H, P, N, per_head)
    _, S = tssm.ssd(*(torch.from_numpy(v[:, :T]) for v in (x, a, b, c)),
                    chunk=8)
    y, S2 = tssm.ssd(*(torch.from_numpy(v[:, T:]) for v in (x, a, b, c)),
                     chunk=8, initial_state=S)
    jy, jS2 = jssm.ssd(*(jnp.asarray(v[:, T:]) for v in (x, a, b, c)),
                       chunk=8, initial_state=jnp.asarray(S.numpy()))
    np.testing.assert_allclose(_np(y), _np(jy), **TOL["float32"])
    np.testing.assert_allclose(_np(S2), _np(jS2), **TOL["float32"])
    y_ref, S_ref = naive_ssd(x, a, b, c)
    np.testing.assert_allclose(_np(y), y_ref[:, T:], **TOL["float32"])
    np.testing.assert_allclose(_np(S2), S_ref, **TOL["float32"])


def test_ssd_keeps_the_reference_chunk_assertion():
    """T = 300 is neither under 256 nor a multiple of it: the reference
    asserts, and so does the port."""
    x, a, b, c = _ssd_inputs(3, 1, 300, 1, 2, 2, False)
    with pytest.raises(AssertionError):
        tssm.ssd(*(torch.from_numpy(v) for v in (x, a, b, c)))


def test_ssd_bf16_returns_the_input_dtype():
    x, a, b, c = _ssd_inputs(4, 1, 32, 2, 4, 4, True)
    jx, tx = _pair(x, "bfloat16")
    y, S = tssm.ssd(tx, *(torch.from_numpy(v) for v in (a, b, c)), chunk=8)
    jy, jS = jssm.ssd(jx, *(jnp.asarray(v) for v in (a, b, c)), chunk=8)
    assert y.dtype == torch.bfloat16 and S.dtype == torch.float32
    np.testing.assert_allclose(_np(y), _np(jy), **TOL["bfloat16"])
    np.testing.assert_allclose(_np(S), _np(jS), **TOL["float32"])


@pytest.mark.parametrize("per_head", [False, True])
def test_ssd_step_continues_scan(per_head):
    """Decoding with ssd_step from ssd's final state == the sequential
    recurrence and the reference's step."""
    B_, T, H, P, N = 1, 32, 2, 4, 4
    x, a, b, c = _ssd_inputs(5, B_, T + 1, H, P, N, per_head)
    y_ref, S_ref = naive_ssd(x, a, b, c)
    _, S = tssm.ssd(*(torch.from_numpy(v[:, :T]) for v in (x, a, b, c)),
                    chunk=8)
    y, S1 = tssm.ssd_step(S, *(torch.from_numpy(v[:, T])
                               for v in (x, a, b, c)))
    jy, jS1 = jssm.ssd_step(jnp.asarray(S.numpy()),
                            *(jnp.asarray(v[:, T]) for v in (x, a, b, c)))
    np.testing.assert_allclose(_np(y), y_ref[:, T], rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(_np(S1), S_ref, rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(_np(y), _np(jy), **TOL["float32"])
    np.testing.assert_allclose(_np(S1), _np(jS1), **TOL["float32"])


# ------------------------------------------------------------ conv
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_causal_conv_bit_equal_whole_and_streamed(dtype):
    B_, T, C, K = 2, 12, 6, 4
    rng = np.random.default_rng(6)
    jx, tx = _pair(rng.standard_normal((B_, T, C)), dtype)
    jw, tw = _pair(rng.standard_normal((K, C)), dtype)
    y, st = tssm.causal_conv(tx, tw)
    jy, jst = jssm.causal_conv(jx, jw)
    assert y.dtype == tx.dtype
    assert _bits_equal(y, jy) and _bits_equal(st, jst)
    state, jstate, outs, jouts = None, None, [], []
    for t in range(T):
        yt, state = tssm.causal_conv(tx[:, t:t + 1], tw, state)
        jyt, jstate = jssm.causal_conv(jx[:, t:t + 1], jw, jstate)
        outs.append(yt)
        jouts.append(jyt)
    assert _bits_equal(torch.cat(outs, 1), jnp.concatenate(jouts, 1))
    assert _bits_equal(state, jstate)
    np.testing.assert_allclose(_np(torch.cat(outs, 1)), _np(y), rtol=1e-5,
                               atol=1e-5)


def test_causal_conv_state_never_aliases_the_old_state():
    """The new state is a view of a fresh tensor: writing it back into
    the state buffer the step read leaves the step's output as it was."""
    rng = np.random.default_rng(7)
    w = torch.from_numpy(rng.standard_normal((4, 3)).astype(np.float32))
    state = torch.from_numpy(rng.standard_normal((1, 3, 3))
                             .astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((1, 1, 3)).astype(np.float32))
    y, new = tssm.causal_conv(x, w, state)
    assert new.data_ptr() != state.data_ptr()
    y0 = y.clone()
    state.copy_(new)
    assert torch.equal(y, y0)
    assert torch.equal(state[:, -1], x[:, 0])


# ------------------------------------------------------------ blocks
BLOCKS = {
    "mamba": ("zamba2-7b", jssm.init_mamba_params, jssm.mamba_block,
              tssm.mamba_block),
    "mlstm": ("xlstm-125m", jssm.init_mlstm_params, jssm.mlstm_block,
              tssm.mlstm_block),
    "slstm": ("xlstm-125m", jssm.init_slstm_params, jssm.slstm_block,
              tssm.slstm_block),
}


def _tree_close(t, j, tol):
    if isinstance(j, dict):
        assert set(t) == set(j)
        for k in j:
            _tree_close(t[k], j[k], tol)
        return
    assert tuple(t.shape) == tuple(j.shape)
    assert str(t.dtype).split(".")[-1] == str(j.dtype)
    np.testing.assert_allclose(_np(t), _np(j), **tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("block", sorted(BLOCKS))
def test_block_matches_reference_with_and_without_state(block, dtype):
    """No state over 10 steps; then the state carried into a chunk of 6
    steps and into one step (the decode path)."""
    arch, jinit, jblock, tblock = BLOCKS[block]
    cfg = jax_smoke(arch).replace(dtype=dtype)
    jp = jinit(jax.random.PRNGKey(3), cfg, DT[dtype])
    tp = params_from_numpy(jax.tree.map(np.asarray, jp))
    u = np.random.default_rng(8).standard_normal((2, 17, cfg.d_model))
    ju, tu = _pair(u, dtype)
    tol = TOL[dtype]
    jblock = jax.jit(jblock, static_argnums=1)
    out, st = tblock(tp, cfg, tu[:, :10])
    jout, jst = jblock(jp, cfg, ju[:, :10])
    assert out.dtype == tu.dtype
    np.testing.assert_allclose(_np(out), _np(jout), **tol)
    _tree_close(st, jst, tol)
    for lo, hi in ((10, 16), (16, 17)):
        out, st = tblock(tp, cfg, tu[:, lo:hi], st)
        jout, jst = jblock(jp, cfg, ju[:, lo:hi], jst)
        np.testing.assert_allclose(_np(out), _np(jout), **tol)
        _tree_close(st, jst, tol)
    # the carried run equals one run over all 17 steps (f32: the chunked
    # and the stepped sums differ in order only)
    if dtype == "float32":
        whole, _ = tblock(tp, cfg, tu)
        np.testing.assert_allclose(_np(out), _np(whole[:, 16:]),
                                   rtol=1e-4, atol=1e-4)
