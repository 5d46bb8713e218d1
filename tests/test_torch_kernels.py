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
        "assert {'k2_streamed_matmul_int8_f32',\n"
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


# ------------------------------------------------------------ K1 in bf16
# The tensor-core kernel's host side: its split of K, the row slicing and
# the workspace. The kernel itself is held on the card by chip_smoke.py.
# (K, N) of the dense FFNs: qwen2-0.5b's and qwen3-14b's, then smoke and
# ragged widths.
FFN_WIDTHS = [(896, 4864), (4864, 896), (5120, 17408), (17408, 5120)]
SPLIT_WIDTHS = FFN_WIDTHS + [(56, 112), (112, 56), (37, 129), (300, 70),
                             (700, 96), (0, 8), (64, 64), (65, 8)]
H100_SMS = 132
ACT_ALLOWANCE = 64 * 2 ** 20     # chip_smoke.py's activations term


def _split_ranges(K, N):
    S, k_split = km.split_plan(K, N)
    return [(s * k_split, min(K, (s + 1) * k_split)) for s in range(S)]


@pytest.mark.parametrize("K,N", SPLIT_WIDTHS)
def test_split_plan_covers_k_in_order(K, N):
    """The split is a function of (K, N) alone (the kernel is given no M to
    see): S ranges covering 0..K in order, each a whole number of 64-row
    k-tiles except the last, none empty."""
    S, k_split = km.split_plan(K, N)
    assert km.split_plan(K, N) == (S, k_split)
    assert k_split >= km.MMA_BK and k_split % km.MMA_BK == 0
    ranges = _split_ranges(K, N)
    assert ranges[0][0] == 0 and ranges[-1][1] == K
    for (a0, a1), (b0, _) in zip(ranges, ranges[1:]):
        assert a1 == b0 and a1 - a0 == k_split
    if K:
        assert all(k1 > k0 for k0, k1 in ranges)
    # what the C entry point derives from (K, k_split): the same S
    assert (max(1, -(-K // k_split))) == S


@pytest.mark.parametrize("K,N", FFN_WIDTHS)
def test_split_plan_fills_the_card_at_ffn_widths(K, N):
    """At the FFN widths one row of output tiles (M <= 16: decode) already
    launches at least one wave of blocks on the H100's 132 SMs."""
    S, _ = km.split_plan(K, N)
    assert -(-N // km.MMA_BN) * S >= H100_SMS


@pytest.mark.parametrize("M", [1, 4, 16, 17, 64, 255, 256, 257, 600, 1000])
def test_row_slices_cover_m(M):
    slices = km.row_slices(M)
    assert slices[0][0] == 0 and slices[-1][1] == M
    assert all(r1 - r0 <= km.ROW_SLICE and r1 > r0 for r0, r1 in slices)
    assert all(a[1] == b[0] for a, b in zip(slices, slices[1:]))


@pytest.mark.parametrize("K,N", FFN_WIDTHS)
def test_workspace_within_bound(K, N):
    """The f32 partials of one row slice stay within WORKSPACE_MAX, far
    inside chip_smoke.py's activations term, at every M (beyond 256 rows
    the slices reuse one workspace)."""
    assert km.WORKSPACE_MAX <= ACT_ALLOWANCE // 2
    S, _ = km.split_plan(K, N)
    for M in (1, 4, 16, 17, 64, 256, 257, 1024):
        shape = km.workspace_shape(M, K, N)
        if S == 1:
            assert shape is None
            continue
        assert shape == (S, min(M, km.ROW_SLICE), N)
        assert 4 * S * shape[1] * N <= km.WORKSPACE_MAX


def test_tile_counters_one_buffer_per_stream(monkeypatch):
    """Launches on two streams may run at once, so each (device, stream)
    gets its own zeroed counter buffer; one stream keeps reusing its own
    and grows it when a launch needs more tiles."""
    monkeypatch.setattr(km, "_COUNTERS", {})
    dev = torch.device("cpu")
    a = km._tile_counters(dev, 11, 100)
    b = km._tile_counters(dev, 22, 100)
    assert a.data_ptr() != b.data_ptr()
    assert km._tile_counters(dev, 11, 50) is a
    assert a.dtype == torch.int32 and not a.any()
    grown = km._tile_counters(dev, 11, a.numel() + 1)
    assert grown.numel() > a.numel() and not grown.any()
    assert km._tile_counters(dev, 22, 100) is b


def test_kernel_variant_by_dtype():
    assert km.kernel_variant(torch.bfloat16) == "mma"
    assert km.kernel_variant(torch.float32) == "fma"
    assert set(km.streamed_matmul.variant_launches) == {"mma", "fma"}


def test_cpu_call_does_not_count_as_a_variant_launch():
    before = dict(km.streamed_matmul.variant_launches)
    km.streamed_matmul(torch.ones(2, 3, dtype=torch.bfloat16),
                       torch.ones(3, 4, dtype=torch.bfloat16))
    assert km.streamed_matmul.variant_launches == before


def test_mma_module_imports_without_nvcc(tmp_path):
    """The tensor-core kernels' library (K1, K2 and K3 in bf16) is
    declared, not built, at import."""
    code = (
        "import repro_torch.kernels.streamed_matmul as km\n"
        "assert km.LIBRARY_MMA.source.name == 'streamed_matmul_mma.cu'\n"
        "assert km.LIBRARY_MMA.source.exists()\n"
        "assert km.LIBRARY_MMA._lib is None and km.LIBRARY._lib is None\n"
        "assert set(km.LIBRARY_MMA.symbols) == {\n"
        "    'k1_streamed_matmul_bf16', 'k2_streamed_matmul_int8_bf16_mma',\n"
        "    'k3_streamed_matmul_int4_bf16_mma'}\n"
        "assert set(km.LIBRARY.symbols) == {\n"
        "    'k1_streamed_matmul_f32', 'k2_streamed_matmul_int8_f32',\n"
        "    'k3_streamed_matmul_int4_f32'}\n")
    src = Path(__file__).resolve().parents[1] / "src"
    env = {"PATH": str(tmp_path), "CUDA_HOME": str(tmp_path / "no-cuda"),
           "PYTHONPATH": str(src), "HOME": str(tmp_path)}
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
