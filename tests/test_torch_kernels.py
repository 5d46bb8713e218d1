"""K1, K2 and K3 (the streamed matmuls) of the PyTorch port against the JAX
reference.

On the CPU the port's wrappers compute their kernels' plain versions; they
are held against the reference's Pallas kernels run in interpret mode, over
the shape sweeps of tests/test_kernels.py and at its tolerances, and
against the reference's oracle (or its dequantiser and a matmul) at ragged
shapes and ragged groups the Pallas kernels cannot tile. The CUDA kernels
themselves are held against the plain versions on the card by
chip_smoke.py.
"""
import subprocess
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as kref
from repro.kernels import streamed_matmul as jsm
from repro.kernels.streamed_matmul import streamed_matmul as jax_streamed
from repro_torch.kernels import streamed_matmul as km
from repro_torch.models.api import tensor_from_numpy

torch.set_num_threads(1)

DTYPES = [jnp.float32, jnp.bfloat16]


def tol(dtype):
    # fp32 bound covers accumulation-order differences vs the oracle
    return dict(rtol=2e-2, atol=2e-2) if dtype == jnp.bfloat16 \
        else dict(rtol=1e-4, atol=5e-4)


def _inputs(seed, M, K, N, dtype):
    rng = np.random.default_rng(seed)
    x = jnp.asarray(rng.standard_normal((M, K)), dtype)
    w = jnp.asarray(rng.standard_normal((K, N)), dtype)
    return x, w, tensor_from_numpy(np.asarray(x)), \
        tensor_from_numpy(np.asarray(w))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("M,K,N,bk", [(128, 512, 256, 128),
                                      (256, 1024, 512, 512),
                                      (64, 256, 128, 64)])
def test_streamed_matmul_matches_pallas_interpret(dtype, M, K, N, bk):
    x, w, tx, tw = _inputs(M + K, M, K, N, dtype)
    ref = jax_streamed(x, w, block_m=64, block_n=64, block_k=bk,
                       interpret=True)
    out = km.streamed_matmul(tx, tw)
    assert out.dtype == tx.dtype and tuple(out.shape) == (M, N)
    np.testing.assert_allclose(out.to(torch.float32).numpy(),
                               np.asarray(ref, np.float32), **tol(dtype))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("M,K,N", [(1, 56, 112), (4, 112, 56), (3, 37, 129),
                                   (17, 896, 70), (1, 4864, 33)])
def test_streamed_matmul_ragged_matches_oracle(dtype, M, K, N):
    """Shapes the Pallas kernel's blocks cannot tile (the smoke widths and
    qwen2-0.5b's 896 / 4864): the port takes them all."""
    x, w, tx, tw = _inputs(M * N, M, K, N, dtype)
    ref = kref.streamed_matmul_ref(x, w)
    out = km.streamed_matmul(tx, tw)
    np.testing.assert_allclose(out.to(torch.float32).numpy(),
                               np.asarray(ref, np.float32), **tol(dtype))


def test_balanced_groups_match_reference():
    from repro.kernels.streamed_matmul import GROUP_SIZE, _balanced_groups
    assert km.GROUP_SIZE == GROUP_SIZE
    for K in (56, 112, 128, 129, 896, 4864, 5000):
        for g0 in (32, 128):
            assert km._balanced_groups(K, g0) == _balanced_groups(K, g0)


def test_cpu_call_does_not_count_as_a_launch():
    before = km.streamed_matmul.launches
    km.streamed_matmul(torch.ones(2, 3), torch.ones(3, 4))
    assert km.streamed_matmul.launches == before


def test_kernel_module_imports_without_nvcc(tmp_path):
    """Importing the kernel modules builds nothing, in a process that
    cannot find nvcc; the build itself needs nvcc and says so."""
    code = (
        "import repro_torch.kernels.streamed_matmul as km\n"
        "from repro_torch.kernels import _build\n"
        "assert km.LIBRARY.source.name == 'streamed_matmul.cu'\n"
        "assert km.LIBRARY.source.exists() and km.LIBRARY._lib is None\n"
        "assert {'k2_streamed_matmul_int8_bf16',\n"
        "        'k3_streamed_matmul_int4_f32'} <= set(km.LIBRARY.symbols)\n"
        "try:\n"
        "    _build.nvcc_path()\n"
        "except RuntimeError as e:\n"
        "    assert 'nvcc not found' in str(e)\n"
        "else:\n"
        "    raise AssertionError('nvcc was found')\n")
    src = Path(__file__).resolve().parents[1] / "src"
    env = {"PATH": str(tmp_path), "CUDA_HOME": str(tmp_path / "no-cuda"),
           "PYTHONPATH": str(src), "HOME": str(tmp_path)}
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr


def _fake_cuda_tensor(shape, dtype=torch.bfloat16):
    return types.SimpleNamespace(device=torch.device("cuda", 0), dtype=dtype,
                                 shape=shape, ndim=len(shape))


def test_cuda_call_without_cuda_raises(monkeypatch):
    """A CUDA-device call launches the kernel or raises: it never falls
    back to the plain version."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x, w = _fake_cuda_tensor((4, 8)), _fake_cuda_tensor((8, 16))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        km.streamed_matmul(x, w)


def test_mixed_devices_raise():
    with pytest.raises(ValueError, match="both must be"):
        km.streamed_matmul(torch.ones(2, 3), _fake_cuda_tensor((3, 4)))
    with pytest.raises(ValueError, match="both must be"):
        km.streamed_matmul(torch.ones(2, 3, device="meta"),
                           torch.ones(3, 4, device="meta"))


# ------------------------------------------------------------ K2, K3
def _quant_inputs(seed, M, K, N, dtype):
    """f32 weights quantised by the reference; x in ``dtype``. Returns
    (jax x, jax w (f32), torch x)."""
    rng = np.random.default_rng(seed)
    x = jnp.asarray(rng.standard_normal((M, K)), dtype)
    w = jnp.asarray(rng.standard_normal((K, N)), jnp.float32)
    return x, w, tensor_from_numpy(np.asarray(x))


def _t_all(arrays):
    return [tensor_from_numpy(np.asarray(a)) for a in arrays]


def _quant_tol(dtype):
    # the reference's int8 / int4 kernel tolerances for f32; bf16 output
    # rounding otherwise
    return dict(rtol=2e-2, atol=2e-2) if dtype == jnp.bfloat16 \
        else dict(rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("M,K,N,bk", [(128, 512, 256, 128),
                                      (64, 256, 128, 128),
                                      (8, 384, 128, 128)])
def test_streamed_matmul_int8_matches_pallas_interpret(dtype, M, K, N, bk):
    x, w, tx = _quant_inputs(M + K, M, K, N, dtype)
    wq, sc = jsm.quantize_int8(w, block_k=bk)
    ref = jsm.streamed_matmul_int8(x, wq, sc, block_k=bk, interpret=True)
    out = km.streamed_matmul_int8(tx, *_t_all((wq, sc)))
    assert out.dtype == tx.dtype and tuple(out.shape) == (M, N)
    np.testing.assert_allclose(out.to(torch.float32).numpy(),
                               np.asarray(ref, np.float32), **_quant_tol(dtype))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("group", [64, 128])
@pytest.mark.parametrize("M,K,N,bk", [(128, 512, 256, None),
                                      (64, 256, 128, 256),
                                      (128, 384, 128, 128)])
def test_streamed_matmul_int4_matches_pallas_interpret(dtype, group, M, K,
                                                       N, bk):
    """The sweep of tests/test_kernels.py; where its block does not hold
    whole groups the Pallas kernel runs at its default block instead."""
    if bk is not None and bk % group:
        bk = None
    x, w, tx = _quant_inputs(M + K + group, M, K, N, dtype)
    q = jsm.quantize_int4(w, group_size=group)
    ref = jsm.streamed_matmul_int4(x, *q, block_m=64, block_n=64,
                                   block_k=bk, interpret=True)
    out = km.streamed_matmul_int4(tx, *_t_all(q))
    assert out.dtype == tx.dtype and tuple(out.shape) == (M, N)
    np.testing.assert_allclose(out.to(torch.float32).numpy(),
                               np.asarray(ref, np.float32), **_quant_tol(dtype))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("M,K,N,group", [(4, 700, 96, 128), (3, 250, 70, 128),
                                         (5, 250, 64, 64), (1, 56, 112, 128),
                                         (17, 4864, 33, 128)])
def test_quantised_ragged_groups_match_dequant_matmul(dtype, M, K, N, group):
    """Ragged groups (K=700: 6 groups of 117) and odd groups (K=250: 2 of
    125, the two nibbles of byte 62 in different groups), which the Pallas
    kernels reject: the port's K2 / K3 equal the reference's dequantiser
    and an f32 matmul, as the reference's jnp fallback computes."""
    x, w, tx = _quant_inputs(M * K + N, M, K, N, dtype)
    xf = x.astype(jnp.float32)
    q8 = jsm.quantize_int8(w, block_k=group)
    ref8 = (xf @ jsm.dequant_int8(*q8)).astype(dtype)
    out8 = km.streamed_matmul_int8(tx, *_t_all(q8))
    np.testing.assert_allclose(out8.to(torch.float32).numpy(),
                               np.asarray(ref8, np.float32),
                               **_quant_tol(dtype))
    q4 = jsm.quantize_int4(w, group_size=group)
    ref4 = (xf @ jsm.dequant_int4(*q4)).astype(dtype)
    out4 = km.streamed_matmul_int4(tx, *_t_all(q4))
    np.testing.assert_allclose(out4.to(torch.float32).numpy(),
                               np.asarray(ref4, np.float32),
                               **_quant_tol(dtype))


def test_quantised_cpu_calls_do_not_count_as_launches():
    q8 = km.quantize_int8(torch.ones(8, 4))
    q4 = km.quantize_int4(torch.ones(8, 4))
    before = (km.streamed_matmul_int8.launches,
              km.streamed_matmul_int4.launches)
    km.streamed_matmul_int8(torch.ones(2, 8), *q8)
    km.streamed_matmul_int4(torch.ones(2, 8), *q4)
    assert (km.streamed_matmul_int8.launches,
            km.streamed_matmul_int4.launches) == before


def test_quantised_cuda_calls_without_cuda_raise(monkeypatch):
    """K2 / K3 on CUDA tensors launch their kernel or raise: they never
    fall back to the plain version, and never mix devices."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = _fake_cuda_tensor((4, 8))
    q8 = (_fake_cuda_tensor((8, 16), torch.int8),
          _fake_cuda_tensor((1, 1, 16), torch.float32))
    q4 = (_fake_cuda_tensor((4, 16), torch.uint8),
          _fake_cuda_tensor((1, 16), torch.float16),
          _fake_cuda_tensor((1, 16), torch.uint8))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        km.streamed_matmul_int8(x, *q8)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        km.streamed_matmul_int4(x, *q4)
    with pytest.raises(ValueError, match="all must be"):
        km.streamed_matmul_int8(torch.ones(4, 8), q8[0],
                                torch.ones(1, 1, 16))
