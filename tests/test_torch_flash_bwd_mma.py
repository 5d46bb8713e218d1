"""K4's backward on the tensor cores, on the CPU: which kernel a call takes,
and the rounding limit chip_smoke.py holds the tensor-core kernel to.

- ``kernel_variant`` for the backward (q, k, v, dout, dq, dk, dv): bf16 with
  a head dim that is a multiple of 8, strides that are multiples of 8 and
  16-byte aligned pointers takes ``"mma"`` (``csrc/flash_attention_bwd_mma
  .cu``), in K4's layout and in the model's (B, T, heads, hd) views that
  autograd hands the backward; f32 and every other bf16 call take
  ``"fma"`` (``csrc/flash_attention_bwd.cu``). The wrapper is driven
  through stand-in libraries to show which entry point it launches and
  what it counts; a CPU call counts nothing.
- The tensor-core kernel's rounding, emulated in plain torch (f32 p, dP
  and D; p and ds rounded to bf16 before the dv, dk and dq sums; f32
  sums; the results rounded to bf16), stays within the limit chip_smoke.py
  derives for it (``BWD_MMA_SCALES``) at small GQA shapes, causal and not,
  with ragged lengths, and beyond the CUDA-core kernel's f32-sum limit; the
  same emulation without the last key tile (dq) or the last query block
  (dk, dv) exceeds it; and its grads are within ``BF16_TOL`` of
  ``jax.vjp`` of the reference's ``attend_flash`` in bf16.
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

from repro.models import attention as jattn
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels.ref import NEG_INF, _scores, flash_attention_ref

torch.set_num_threads(1)

BF16_TOL = 2e-2


# ------------------------------------------------------------ variants
def _bthd(B, T, heads, hd, dtype):
    """A (B, T, heads, hd) tensor as the (B, heads, T, hd) view the
    backward takes (``_heads(t, bthd=True)``)."""
    return torch.zeros(B, T, heads, hd, dtype=dtype).transpose(1, 2)


def _bwd_views(B, T, H, KV, hd, dtype):
    """q, k, v, dout, dq, dk, dv as autograd hands them to the backward in
    the model's layout."""
    q, dout, dq = (_bthd(B, T, H, hd, dtype) for _ in range(3))
    k, v, dk, dv = (_bthd(B, T, KV, hd, dtype) for _ in range(4))
    return q, k, v, dout, dq, dk, dv


@pytest.mark.parametrize("H,KV,hd", [(14, 2, 64),     # qwen2-0.5b
                                     (28, 4, 128),    # qwen2-vl-7b
                                     (16, 16, 80),    # vision encoder
                                     (32, 32, 112),   # zamba2-7b
                                     (24, 24, 64),    # musicgen-medium
                                     (4, 2, 40)])     # hd a multiple of 8
def test_backward_variant_bf16_takes_tensor_cores(H, KV, hd):
    views = _bwd_views(1, 37, H, KV, hd, torch.bfloat16)
    assert views[3].stride(2) == H * hd
    assert fa.kernel_variant(*views) == "mma"
    q, dout = (torch.zeros(2, H, 37, hd, dtype=torch.bfloat16)
               for _ in range(2))
    k = torch.zeros(2, KV, 37, hd, dtype=torch.bfloat16)
    assert fa.kernel_variant(q, k, k, dout, torch.empty_like(q),
                             torch.empty_like(k), torch.empty_like(k)) \
        == "mma"


@pytest.mark.parametrize("H,KV,hd", [(14, 2, 64), (28, 4, 128)])
def test_backward_variant_f32_takes_cuda_cores(H, KV, hd):
    assert fa.kernel_variant(*_bwd_views(1, 37, H, KV, hd,
                                         torch.float32)) == "fma"


@pytest.mark.parametrize("case", ["hd36", "dout_stride", "dq_offset",
                                  "dk_stride"])
def test_backward_variant_unaligned_bf16_takes_cuda_cores(case):
    views = list(_bwd_views(1, 37, 4, 2, 64, torch.bfloat16))
    if case == "hd36":                       # hd not a multiple of 8
        views = _bwd_views(1, 37, 4, 2, 36, torch.bfloat16)
    elif case == "dout_stride":              # row stride 4 * 64 + 4
        views[3] = torch.zeros(1, 37, 4 * 64 + 4, dtype=torch.bfloat16)[
            ..., :4 * 64].reshape(1, 37, 4, 64).transpose(1, 2)
        assert views[3].stride(2) % 8 == 4
    elif case == "dq_offset":                # a pointer 2 bytes off
        flat = torch.zeros(1 + 37 * 4 * 64, dtype=torch.bfloat16)
        views[4] = flat[1:].reshape(1, 37, 4, 64).transpose(1, 2)
    else:                                    # a head stride of 68
        views[5] = torch.zeros(1, 2, 37, 68, dtype=torch.bfloat16)[..., :64]
        assert views[5].stride(2) % 8 == 4
    assert fa.kernel_variant(*views) == "fma"


class _Recorder:
    """A stand-in for a ``CudaLibrary``: every entry point records its
    arguments and returns 0 (cudaSuccess)."""

    def __init__(self, symbols):
        self.symbols = symbols
        self.calls = []

    def lib(self):
        def entry(name):
            def fn(*args):
                self.calls.append((name, args))
                return 0
            return fn
        return types.SimpleNamespace(**{n: entry(n) for n in self.symbols})


@pytest.fixture
def recorded(monkeypatch):
    """The backward's CUDA path on CPU tensors, with both backward
    libraries recording instead of launching."""
    mma = _Recorder(fa.LIBRARY_BWD_MMA.symbols)
    fma = _Recorder(fa.LIBRARY_BWD.symbols)
    monkeypatch.setattr(fa, "LIBRARY_BWD_MMA", mma)
    monkeypatch.setattr(fa, "LIBRARY_BWD", fma)
    monkeypatch.setattr(fa, "on_cpu", lambda *a: False)
    monkeypatch.setattr(fa, "_stream", lambda dev: 7)
    return mma, fma


def _inputs(B, T, H, KV, hd, dtype, bthd):
    g = torch.Generator().manual_seed(5)
    shape = (lambda n: (B, T, n, hd)) if bthd else (lambda n: (B, n, T, hd))
    q, dout = (torch.randn(shape(H), generator=g).to(dtype)
               for _ in range(2))
    k, v = (torch.randn(shape(KV), generator=g).to(dtype) for _ in range(2))
    lse = torch.zeros(B, H, T)
    return q, k, v, dout, lse


@pytest.mark.parametrize("bthd", [False, True])
@pytest.mark.parametrize("dtype,hd,variant,symbol", [
    (torch.bfloat16, 64, "mma", "k4_flash_attention_bwd_bf16_mma"),
    (torch.bfloat16, 128, "mma", "k4_flash_attention_bwd_bf16_mma"),
    (torch.bfloat16, 36, "fma", "k4_flash_attention_bwd_bf16"),
    (torch.float32, 64, "fma", "k4_flash_attention_bwd_f32")])
def test_backward_launches_the_picked_kernel(recorded, bthd, dtype, hd,
                                             variant, symbol):
    """One entry point a call, the one ``kernel_variant`` names, with the
    declared arguments (the 21 strides of the (B, heads, T, hd) views) and
    one count under that kernel."""
    mma, fma = recorded
    B, T, H, KV = 2, 37, 4, 2
    q, k, v, dout, lse = _inputs(B, T, H, KV, hd, dtype, bthd)
    before = (fa.flash_attention_backward.launches,
              dict(fa.flash_attention_backward.variant_launches))
    dq, dk, dv = fa.flash_attention_backward(q, k, v, dout, lse,
                                             causal=True, bthd=bthd)
    lib, other = (mma, fma) if variant == "mma" else (fma, mma)
    assert other.calls == [] and [c[0] for c in lib.calls] == [symbol]
    args = lib.calls[0][1]
    assert len(args) == len(fa._K4_BWD_ARGS)
    assert list(args[:4]) == [t.data_ptr() for t in (q, k, v, dout)]
    assert args[4] == lse.data_ptr()
    assert list(args[6:9]) == [t.data_ptr() for t in (dq, dk, dv)]
    assert args[9:15] == (B, H, KV, T, T, hd)
    views = [t.transpose(1, 2) if bthd else t
             for t in (q, k, v, dout, dq, dk, dv)]
    assert list(args[15]) == [s for t in views for s in t.stride()[:3]]
    assert args[16:] == (1, pytest.approx(hd ** -0.5), 7)
    for g, t in zip((dq, dk, dv), (q, k, v)):
        assert g.shape == t.shape and g.dtype == t.dtype
    want = dict(before[1])
    want[variant] += 1
    assert fa.flash_attention_backward.launches == before[0] + 1
    assert fa.flash_attention_backward.variant_launches == want


def test_cpu_backward_does_not_count_a_variant_launch():
    before = dict(fa.flash_attention_backward.variant_launches)
    assert set(before) == {"mma", "fma"}
    q, k, v, dout, lse = _inputs(1, 8, 2, 1, 16, torch.bfloat16, False)
    fa.flash_attention_backward(q, k, v, dout, lse, causal=True)
    assert fa.flash_attention_backward.variant_launches == before


def test_bwd_mma_module_imports_without_nvcc(tmp_path):
    """The tensor-core backward's library is declared, not built, at
    import."""
    code = (
        "import repro_torch.kernels.flash_attention as fa\n"
        "lib = fa.LIBRARY_BWD_MMA\n"
        "assert lib.source.name == 'flash_attention_bwd_mma.cu'\n"
        "assert lib.source.exists() and lib._lib is None\n"
        "assert set(lib.symbols) == {'k4_flash_attention_bwd_bf16_mma'}\n")
    src = Path(__file__).resolve().parents[1] / "src"
    env = {"PATH": str(tmp_path), "CUDA_HOME": str(tmp_path / "no-cuda"),
           "PYTHONPATH": str(src), "HOME": str(tmp_path)}
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr


# ------------------------------------------------------------ the limit
def _chip_smoke():
    import importlib.util
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def mma_rounding(q, k, v, dout, lse, causal):
    """The tensor-core kernel's arithmetic in plain torch: f32 p
    (exp(s - lse), 0 where masked), dP and D = rowsum(p dP); p and ds
    rounded to bf16 before the dv, dk and dq sums, every sum in f32, dk
    and dq scaled after the sum; the results in bf16."""
    B, H, Tq, hd = q.shape
    KV = k.shape[1]
    G = H // KV
    s, qg = _scores(q, k, causal)
    p = torch.where(s > NEG_INF / 2,
                    torch.exp(s - lse.reshape(B, KV, G, Tq, 1)), 0.0)
    dog = dout.reshape(B, KV, G, Tq, hd).float()
    dp = torch.einsum("bkgtd,bksd->bkgts", dog, v.float())
    ds = p * (dp - (p * dp).sum(-1, keepdim=True))
    pb, dsb = p.bfloat16().float(), ds.bfloat16().float()
    dv = torch.einsum("bkgts,bkgtd->bksd", pb, dog)
    dq = torch.einsum("bkgts,bksd->bkgtd", dsb, k.float()) * hd ** -0.5
    dk = torch.einsum("bkgts,bkgtd->bksd", dsb, qg) * hd ** -0.5
    return (dq.reshape(B, H, Tq, hd).bfloat16(), dk.bfloat16(),
            dv.bfloat16())


def _bf16_inputs(shape, causal, seed):
    B, H, KV, Tq, Tk, hd = shape
    rng = np.random.default_rng(seed)
    q, k, v, dout = (torch.from_numpy(rng.standard_normal(s,
                                                          dtype=np.float32))
                     .to(torch.bfloat16)
                     for s in ((B, H, Tq, hd), (B, KV, Tk, hd),
                               (B, KV, Tk, hd), (B, H, Tq, hd)))
    _, lse = flash_attention_ref(q, k, v, causal=causal, return_lse=True)
    return q, k, v, dout, lse


LIMIT_SHAPES = [((1, 4, 2, 200, 200, 64), True),     # GQA, ragged 200
                ((1, 4, 2, 200, 200, 64), False),
                ((1, 6, 3, 131, 131, 80), False),    # vision's hd
                ((2, 4, 1, 97, 150, 128), True),     # Tq < Tk, hd 128
                ((1, 4, 4, 150, 97, 112), True)]     # Tq > Tk, zamba2's hd
# where the dropped tiles are seen (under causal with Tq < Tk no row sees
# the last keys, so dropping them is no fault)
FAULT_SHAPES = [(s, c) for s, c in LIMIT_SHAPES if not (c and s[3] < s[4])]


@pytest.mark.parametrize("shape,causal", LIMIT_SHAPES)
def test_mma_rounding_within_its_limit_beyond_the_f32_sum_limit(shape,
                                                                causal):
    cs = _chip_smoke()
    inputs = _bf16_inputs(shape, causal, seed=sum(shape))
    refs, abss, rss = cs.attention_bwd_f32(*inputs, causal, with_rss=True)
    grads = mma_rounding(*inputs, causal)
    for g, r, a, s in zip(grads, refs, abss, rss):
        assert cs.bwd_excess(g, r, a, "bfloat16", s) <= 0.6
    # the CUDA-core kernel's limit assumes f32 sums of exact products
    assert max(cs.bwd_excess(g, r, a, "bfloat16")
               for g, r, a in zip(grads, refs, abss)) > 1.0


@pytest.mark.parametrize("shape,causal", FAULT_SHAPES)
def test_mma_limit_rejects_a_dropped_tile(shape, causal):
    """chip_smoke.py's planted faults on the emulation: dq without the last
    key tile, dk and dv without the last query block."""
    cs = _chip_smoke()
    q, k, v, dout, lse = _bf16_inputs(shape, causal, seed=sum(shape))
    refs, abss, rss = cs.attention_bwd_f32(q, k, v, dout, lse, causal,
                                           with_rss=True)
    Tq, Tk = shape[3], shape[4]
    drop_k = Tk - (Tk - 1) // 64 * 64
    drop_q = Tq - (Tq - 1) // 64 * 64
    dq, _, _ = mma_rounding(q, k[:, :, :-drop_k], v[:, :, :-drop_k], dout,
                            lse, causal)
    assert cs.bwd_excess(dq, refs[0], abss[0], "bfloat16", rss[0]) > 2.0
    _, dk, dv = mma_rounding(q[:, :, :-drop_q], k, v, dout[:, :, :-drop_q],
                             lse[:, :, :-drop_q].contiguous(), causal)
    assert max(cs.bwd_excess(dk, refs[1], abss[1], "bfloat16", rss[1]),
               cs.bwd_excess(dv, refs[2], abss[2], "bfloat16",
                             rss[2])) > 2.0


@pytest.mark.parametrize("causal", [True, False])
def test_mma_rounding_matches_reference_attend_flash_grads(causal):
    """The emulated tensor-core gradients against ``jax.vjp`` of the
    reference's ``attend_flash`` in bf16, in the model's layout."""
    B, T, H, KV, hd = 1, 256, 4, 2, 32
    rng = np.random.RandomState(3)
    q, dout = (rng.randn(B, T, H, hd).astype(np.float32) for _ in range(2))
    k, v = (rng.randn(B, T, KV, hd).astype(np.float32) for _ in range(2))
    args = [jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)]
    _, vjp = jax.vjp(lambda q, k, v: jattn.attend_flash(
        q, k, v, causal=causal, q_chunk=64, kv_chunk=64), *args)
    want = [np.asarray(g, np.float32)
            for g in vjp(jnp.asarray(dout, jnp.bfloat16))]
    qh, kh, vh, doh = (torch.from_numpy(a).to(torch.bfloat16).transpose(1, 2)
                       for a in (q, k, v, dout))
    _, lse = flash_attention_ref(qh, kh, vh, causal=causal, return_lse=True)
    got = [g.transpose(1, 2).float().numpy()
           for g in mma_rounding(qh, kh, vh, doh, lse, causal)]
    for g, w in zip(got, want):
        assert g.shape == w.shape
        err = np.abs(g - w).max() / np.abs(w).max()
        assert err <= BF16_TOL, err
