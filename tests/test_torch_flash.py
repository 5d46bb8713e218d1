"""K4 (flash attention) of the PyTorch port against the JAX reference.

On the CPU the port's ``flash_attention`` computes its plain version; it is
held against the reference's Pallas kernel in interpret mode over the sweep
of tests/test_kernels.py at its tolerances, and the model-layout wrappers
and the ``attend`` switch against the reference's on the shapes of
tests/test_attention.py. Ragged lengths, which the reference's kernel and
jnp scan cannot tile, are held against the reference's ``attend_ref``. The
CUDA kernel itself is held against the plain version on the card by
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

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as jax_flash
from repro.models import attention as jattn
from repro_torch.kernels import flash_attention as kfa
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.models import attention as tattn
from repro_torch.models.api import tensor_from_numpy

torch.set_num_threads(1)

DTYPES = [jnp.float32, jnp.bfloat16]
SWEEP = [(1, 4, 4, 128, 64),    # MHA
         (2, 8, 2, 256, 64),    # GQA 4x
         (1, 6, 2, 192, 128)]   # GQA 3x, odd block division
# attend_flash against the reference's: f32 differs only in the order of
# sums; in bf16 the reference's scan rounds p to bf16 before p @ v and the
# port (as the Pallas kernel) does not
ATTN_TOL = {jnp.float32: dict(rtol=2e-5, atol=2e-5),
            jnp.bfloat16: dict(rtol=2e-2, atol=2e-2)}


def tol(dtype):
    # tests/test_kernels.py: fp32 bound covers accumulation-order
    # differences vs the oracle
    return dict(rtol=2e-2, atol=2e-2) if dtype == jnp.bfloat16 \
        else dict(rtol=1e-4, atol=5e-4)


def _qkv(seed, qshape, kvshape, dtype):
    """The same numpy-seeded q, k, v for both packages."""
    rng = np.random.default_rng(seed)
    js = [jnp.asarray(rng.standard_normal(s), dtype)
          for s in (qshape, kvshape, kvshape)]
    return js, [tensor_from_numpy(np.asarray(a)) for a in js]


def _f32(x):
    if torch.is_tensor(x):
        return x.to(torch.float32).numpy()
    return np.asarray(x, np.float32)


# ------------------------------------------------------------ the kernel
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,H,KV,T,hd", SWEEP)
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_matches_pallas_interpret(dtype, B, H, KV, T, hd,
                                                  causal):
    (q, k, v), (tq, tk, tv) = _qkv(B * T + hd, (B, H, T, hd),
                                   (B, KV, T, hd), dtype)
    ref = jax_flash(q, k, v, causal=causal, block_q=64, block_k=64,
                    interpret=True)
    out = kfa.flash_attention(tq, tk, tv, causal=causal, block_q=64,
                              block_k=64)
    assert out.dtype == tq.dtype and tuple(out.shape) == (B, H, T, hd)
    np.testing.assert_allclose(_f32(out), _f32(ref), **tol(dtype))


@pytest.mark.parametrize("block_q", [32, 64, 128])
def test_flash_q_chunk_knob(block_q):
    """VLMOpt Q-chunking: results identical across chunk sizes, to the
    reference's own 2e-5, against its oracle and its Pallas kernel."""
    (q, k, v), (tq, tk, tv) = _qkv(5, (1, 4, 256, 64), (1, 4, 256, 64),
                                   jnp.float32)
    out = kfa.flash_attention(tq, tk, tv, causal=False, block_q=block_q,
                              block_k=64)
    for ref in (jref.flash_attention_ref(q, k, v, causal=False),
                jax_flash(q, k, v, causal=False, block_q=block_q,
                          block_k=64, interpret=True)):
        np.testing.assert_allclose(_f32(out), _f32(ref), rtol=2e-5,
                                   atol=2e-5)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_ref_matches_reference_oracle(dtype, causal):
    """The plain version is the reference's ``flash_attention_ref``,
    Tq != Tk included (positions from 0 for both)."""
    (q, k, v), (tq, tk, tv) = _qkv(11, (2, 6, 48, 32), (2, 3, 80, 32),
                                   dtype)
    ref = jref.flash_attention_ref(q, k, v, causal=causal)
    out = tref.flash_attention_ref(tq, tk, tv, causal=causal)
    assert out.dtype == tq.dtype
    np.testing.assert_allclose(_f32(out), _f32(ref), **tol(dtype))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_bthd_matches_reference(dtype, causal):
    (q, k, v), (tq, tk, tv) = _qkv(13, (2, 128, 8, 64), (2, 128, 2, 64),
                                   dtype)
    ref = jops.flash_attention_bthd(q, k, v, causal=causal, block_q=64,
                                    block_k=64, force=True)
    out = tops.flash_attention_bthd(tq, tk, tv, causal=causal, block_q=64,
                                    block_k=64)
    assert tuple(out.shape) == (2, 128, 8, 64)
    np.testing.assert_allclose(_f32(out), _f32(ref), **tol(dtype))


def test_cpu_call_does_not_count_as_a_launch():
    before = kfa.flash_attention.launches
    x = torch.ones(1, 2, 4, 8)
    kfa.flash_attention(x, x, x)
    tops.flash_attention_bthd(x, x, x)
    assert kfa.flash_attention.launches == before


def _fake_cuda_tensor(shape, dtype=torch.bfloat16):
    return types.SimpleNamespace(device=torch.device("cuda", 0), dtype=dtype,
                                 shape=shape, ndim=len(shape))


def test_cuda_call_without_cuda_raises(monkeypatch):
    """A CUDA-device call launches the kernel or raises: it never falls
    back to the plain version."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    q = _fake_cuda_tensor((1, 2, 4, 8))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        kfa.flash_attention(q, q, q)


def test_mixed_devices_raise():
    with pytest.raises(ValueError, match="all must be"):
        kfa.flash_attention(torch.ones(1, 2, 4, 8), torch.ones(1, 2, 4, 8),
                            _fake_cuda_tensor((1, 2, 4, 8)))


@pytest.mark.parametrize("shapes,match", [
    (((1, 3, 4, 8), (1, 2, 4, 8)), "multiple of"),
    (((1, 2, 4, 136), (1, 2, 4, 136)), "head dim"),
    (((1, 2, 4, 8), (1, 2, 4, 16)), "do not match"),
])
def test_unsupported_shapes_raise(shapes, match):
    q, k = (torch.ones(s) for s in shapes)
    with pytest.raises(ValueError, match=match):
        kfa.flash_attention(q, k, k)


@pytest.mark.parametrize("block_q,block_k", [(0, 64), (64, 0)])
def test_nonpositive_chunks_raise(block_q, block_k):
    """K4 tiles the query axis itself and takes any positive Q-chunk, but
    checks it as it checks the KV-chunk."""
    q = torch.ones(1, 2, 4, 8)
    with pytest.raises(ValueError, match="must be positive"):
        kfa.flash_attention(q, q, q, block_q=block_q, block_k=block_k)


def test_kernel_module_imports_without_nvcc(tmp_path):
    """Importing K4's modules builds nothing, in a process that cannot
    find nvcc."""
    code = (
        "import repro_torch.kernels.flash_attention as fa\n"
        "import repro_torch.kernels.ops\n"
        "import repro_torch.models.attention\n"
        "import repro_torch.core.vlmopt\n"
        "assert fa.LIBRARY.source.name == 'flash_attention.cu'\n"
        "assert fa.LIBRARY.source.exists() and fa.LIBRARY._lib is None\n"
        "assert set(fa.LIBRARY.symbols) == {'k4_flash_attention_bf16',\n"
        "                                   'k4_flash_attention_f32'}\n")
    src = Path(__file__).resolve().parents[1] / "src"
    env = {"PATH": str(tmp_path), "CUDA_HOME": str(tmp_path / "no-cuda"),
           "PYTHONPATH": str(src), "HOME": str(tmp_path)}
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr


# ------------------------------------------------------------ the layer
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("T,H,KV,hd,qc,kc", [(256, 8, 2, 64, 64, 64),
                                             (128, 4, 4, 32, 32, 64),
                                             (512, 6, 2, 16, 64, 64)])
def test_attend_flash_matches_reference(dtype, causal, T, H, KV, hd, qc, kc):
    """tests/test_attention.py's shapes, through both packages'
    ``attend_flash``."""
    (q, k, v), (tq, tk, tv) = _qkv(T + H, (2, T, H, hd), (2, T, KV, hd),
                                   dtype)
    ref = jattn.attend_flash(q, k, v, causal=causal, q_chunk=qc, kv_chunk=kc)
    out = tattn.attend_flash(tq, tk, tv, causal=causal, q_chunk=qc,
                             kv_chunk=kc)
    assert out.dtype == tq.dtype
    np.testing.assert_allclose(_f32(out), _f32(ref), **ATTN_TOL[dtype])


@pytest.mark.parametrize("T", [64, 2048, 2049, 3072])
def test_attend_switch_matches_reference(T):
    """``attend`` on both sides of FLASH_THRESHOLD = 2048: the reference
    takes its jnp scan above it and ``attend_ref`` at or below."""
    assert tattn.FLASH_THRESHOLD == jattn.FLASH_THRESHOLD == 2048
    assert (tattn.Q_CHUNK, tattn.KV_CHUNK) == (jattn.Q_CHUNK, jattn.KV_CHUNK)
    if T == 2049:   # the reference's scan cannot tile 2049: the port only
        (q, k, v), (tq, tk, tv) = _qkv(T, (1, T, 2, 8), (1, T, 1, 8),
                                       jnp.float32)
        ref = jattn.attend_ref(q, k, v, causal=True)
    else:
        (q, k, v), (tq, tk, tv) = _qkv(T, (1, T, 2, 8), (1, T, 1, 8),
                                       jnp.float32)
        ref = jattn.attend(q, k, v, causal=True)
    out = tattn.attend(tq, tk, tv, causal=True)
    np.testing.assert_allclose(_f32(out), _f32(ref), rtol=2e-5, atol=2e-5)


def test_attend_takes_flash_only_above_threshold(monkeypatch):
    calls = []
    real = tattn.attend_flash

    def spy(*a, **kw):
        calls.append(a[0].shape[1])
        return real(*a, **kw)

    monkeypatch.setattr(tattn, "attend_flash", spy)
    for T in (2048, 2049):
        x = torch.zeros(1, T, 1, 4)
        tattn.attend(x, x, x)
    tattn.attend(torch.zeros(1, 2049, 1, 4), torch.zeros(1, 2050, 1, 4),
                 torch.zeros(1, 2050, 1, 4))
    assert calls == [2049]


@pytest.mark.parametrize("T", [130, 193])
@pytest.mark.parametrize("causal", [True, False])
def test_ragged_lengths_match_reference_attend_ref(T, causal):
    """Lengths the reference's kernel and scan cannot tile (no chunk
    divides them), through the port's ``attend_flash``, against the
    reference's fully materialised ``attend_ref``."""
    (q, k, v), (tq, tk, tv) = _qkv(T, (2, T, 6, 16), (2, T, 2, 16),
                                   jnp.float32)
    ref = jattn.attend_ref(q, k, v, causal=causal)
    out = tattn.attend_flash(tq, tk, tv, causal=causal, q_chunk=64,
                             kv_chunk=64)
    np.testing.assert_allclose(_f32(out), _f32(ref), rtol=2e-5, atol=2e-5)


# ------------------------------------------------------------ K4 variants
# Which kernel a call takes: a pure function of the dtype, the head dim,
# the strides and the pointers' alignment (kernel_variant). The kernels
# themselves are held on the card by chip_smoke.py.
def _bthd_views(B, T, H, KV, hd, dtype):
    """q, k, v, out as ops.flash_attention_bthd hands them to the kernel:
    (B, T, heads, hd) tensors transposed to (B, heads, T, hd) views."""
    q = torch.zeros(B, T, H, hd, dtype=dtype)
    k = torch.zeros(B, T, KV, hd, dtype=dtype)
    out = torch.empty(q.shape, dtype=dtype)
    return (q.transpose(1, 2), k.transpose(1, 2), k.transpose(1, 2),
            out.transpose(1, 2))


@pytest.mark.parametrize("H,KV,hd", [(16, 16, 80),     # VLMOpt encoder
                                     (28, 4, 128)])    # qwen2-vl-7b
def test_variant_bf16_vlm_shapes_take_tensor_cores(H, KV, hd):
    views = _bthd_views(1, 37, H, KV, hd, torch.bfloat16)
    assert views[0].stride(2) == H * hd        # the row stride is H * hd
    assert kfa.kernel_variant(*views) == "mma"
    q = torch.zeros(1, H, 37, hd, dtype=torch.bfloat16)
    kv = torch.zeros(1, KV, 37, hd, dtype=torch.bfloat16)
    assert kfa.kernel_variant(q, kv, kv, torch.empty_like(q)) == "mma"


@pytest.mark.parametrize("H,KV,hd", [(16, 16, 80), (28, 4, 128)])
def test_variant_f32_takes_cuda_cores(H, KV, hd):
    assert kfa.kernel_variant(*_bthd_views(1, 37, H, KV, hd,
                                           torch.float32)) == "fma"


def test_variant_qkv_slices_of_one_projection():
    """q, k and v cut from one fused projection keep 16-byte rows."""
    qkv = torch.zeros(1, 37, 16 * 80 * 3, dtype=torch.bfloat16)
    q, k, v = (t.reshape(1, 37, 16, 80).transpose(1, 2)
               for t in qkv.split(16 * 80, dim=-1))
    assert kfa.kernel_variant(q, k, v, torch.empty_like(q)) == "mma"


@pytest.mark.parametrize("case", ["hd20", "odd_stride", "offset"])
def test_variant_unaligned_bf16_takes_cuda_cores(case):
    if case == "hd20":                       # hd not a multiple of 8
        views = _bthd_views(1, 37, 4, 2, 20, torch.bfloat16)
    elif case == "odd_stride":               # row stride 3 * 40 + 4
        base = torch.zeros(1, 4, 37, 44, dtype=torch.bfloat16)
        q = base[..., :40]
        views = (q, q[:, :2], q[:, :2], torch.empty_like(q))
        assert q.stride(2) % 8 == 4
    else:                                    # a pointer 2 bytes off
        flat = torch.zeros(1 + 4 * 37 * 64, dtype=torch.bfloat16)
        q = flat[1:].reshape(1, 4, 37, 64)
        views = (q, q, q, torch.empty_like(q))
    assert kfa.kernel_variant(*views) == "fma"


def test_cpu_call_does_not_count_as_a_variant_launch():
    before = dict(kfa.flash_attention.variant_launches)
    x = torch.ones(1, 2, 4, 8, dtype=torch.bfloat16)
    kfa.flash_attention(x, x, x)
    assert kfa.flash_attention.variant_launches == before
    assert set(before) == {"mma", "fma"}


def test_mma_module_imports_without_nvcc(tmp_path):
    """The tensor-core kernel's library is declared, not built, at import."""
    code = (
        "import repro_torch.kernels.flash_attention as fa\n"
        "assert fa.LIBRARY_MMA.source.name == 'flash_attention_mma.cu'\n"
        "assert fa.LIBRARY_MMA.source.exists()\n"
        "assert fa.LIBRARY_MMA._lib is None\n"
        "assert set(fa.LIBRARY_MMA.symbols) == "
        "{'k4_flash_attention_bf16_mma'}\n")
    src = Path(__file__).resolve().parents[1] / "src"
    env = {"PATH": str(tmp_path), "CUDA_HOME": str(tmp_path / "no-cuda"),
           "PYTHONPATH": str(src), "HOME": str(tmp_path)}
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr


# ------------------------------------------------------------ bf16-p limit
# chip_smoke.py holds K4 on the tensor cores to a limit set by its rounding
# of p and of the output to bf16. On the CPU: that rounding, emulated on
# the plain version's f32 attention, stays within the limit, and the same
# attention without its last 33 keys (a dropped kv tile) does not.
def _chip_smoke():
    import importlib.util
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("causal,H,KV,hd", [(True, 4, 2, 128),
                                            (False, 4, 4, 80)])
def test_bf16_p_limit_passes_rounding_and_rejects_a_dropped_tile(
        causal, H, KV, hd):
    cs = _chip_smoke()
    T, drop = 300, 33
    rng = np.random.default_rng(7)
    q, k, v = (torch.from_numpy(rng.standard_normal(s, dtype=np.float32))
               .to(torch.bfloat16)
               for s in ((1, H, T, hd), (1, KV, T, hd), (1, KV, T, hd)))
    o, r = cs.attention_f32(q, k, v, causal)
    # p rounded to bf16 after the row max, l from the f32 p, bf16 output
    qg = q.reshape(1, KV, H // KV, T, hd).float()
    s = torch.einsum("bkgtd,bksd->bkgts", qg, k.float()) * hd ** -0.5
    if causal:
        s = torch.where(torch.ones(T, T, dtype=torch.bool).tril(), s,
                        tref.NEG_INF)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    rounded = (torch.einsum("bkgts,bksd->bkgtd", p.bfloat16().float(),
                            v.float()) / p.sum(-1, keepdim=True)) \
        .reshape(1, H, T, hd).bfloat16()
    assert cs.p_round_excess(rounded, o, r) <= 0.5
    dropped, _ = cs.attention_f32(q, k[:, :, :-drop], v[:, :, :-drop],
                                  causal)
    assert cs.p_round_excess(dropped.bfloat16(), o, r) > 2.0
