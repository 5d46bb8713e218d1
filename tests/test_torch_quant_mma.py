"""K2 and K3 in bf16 on the tensor cores: the factored form, its numerics
and the wrapper's host side, on the CPU.

The kernel (``csrc/streamed_matmul_mma.cu``) computes
``sum_g s_g * (x_g @ (q_g - z_g))``: exact bf16 tiles of codes, f32 group
partials, each scaled once where its group ends. Here that form, written
out in plain torch as the kernel walks it (splits, k-tiles, k16 steps,
steps cut by a group boundary run once per group), is held against the
JAX package's Pallas kernels in interpret mode and its dequantise-then-
matmul reference; the integer codes are shown to be exact in bf16; and
the wrapper is driven through a stand-in library to show what it launches.
The CUDA kernel itself is held against the plain versions on the card by
chip_smoke.py.
"""
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import streamed_matmul as jsm
from repro_torch.kernels import streamed_matmul as km
from repro_torch.models.api import tensor_from_numpy

torch.set_num_threads(1)

def _t(a):
    return tensor_from_numpy(np.asarray(a))


def _assert_f32_close(out, ref, x, wd):
    """f32 inputs and f32 sums on both sides, which differ only in the
    rounding of the sums (and of s * q): within 1e-5 of |ref| plus sixteen
    f32 units (2^-20) of sum_k |x_k w_kn|, the scale of a sum's rounding.
    One row left out or scaled by another group's scale is far outside."""
    scale = np.abs(np.asarray(x, np.float64)) @ np.abs(np.asarray(wd,
                                                                  np.float64))
    ref = np.asarray(ref, np.float64)
    err = np.abs(out.numpy().astype(np.float64) - ref)
    lim = 1e-5 * np.abs(ref) + 2.0 ** -20 * scale
    assert (err <= lim).all(), f"excess {(err / lim).max():.3f}"


def _codes_and_scales(mode, q):
    """The kernel's operands from a quantiser's output: integer codes
    (q, or q - z[group]) as a (K, N) f64 tensor and the scales (G, N)."""
    if mode == "int8":
        wq, sc = q
        return wq.to(torch.float64), sc[:, 0, :].to(torch.float64)
    packed, sc, z = q
    K = 2 * packed.shape[0]
    G = sc.shape[0]
    g = -(-K // G)
    rows = torch.arange(K) // g
    codes = km.unpack_int4(packed).to(torch.float64) \
        - z.to(torch.float64)[rows]
    return codes, sc.to(torch.float64)


def scheduled(x, codes, s, g, dtype=torch.float32):
    """The factored form as the bf16 kernel walks it, in ``dtype``: for
    each split of ``split_plan(K, N)``, its k16 steps in order; a step runs
    once per group its rows touch (the other groups' rows left out) and
    adds into the group partial; where the group ends, or the split does,
    the partial is scaled into the split's sum and cleared; the splits are
    added in order. A test helper, on no path."""
    M, K = x.shape
    N = codes.shape[1]
    x, codes, s = (t.to(dtype) for t in (x, codes, s))
    S, k_split = km.split_plan(K, N)
    total = None
    for split in range(S):
        kbeg, kend = split * k_split, min(K, (split + 1) * k_split)
        acc = torch.zeros((M, N), dtype=dtype)
        part = torch.zeros((M, N), dtype=dtype)
        for kb in range(kbeg, kend, 16):
            rows = torch.arange(kb, min(kb + 16, kend))
            for gi in range(kb // g, (min(kb + 16, kend) - 1) // g + 1):
                sel = rows[rows // g == gi]
                part = part + x[:, sel] @ codes[sel]
                if (gi + 1) * g <= kb + 16 or kb + 16 >= kend:
                    acc = acc + s[gi] * part
                    part = torch.zeros_like(part)
        total = acc if total is None else total + acc
    return total


def _inputs(seed, M, K, N):
    rng = np.random.default_rng(seed)
    x = jnp.asarray(rng.standard_normal((M, K)), jnp.float32)
    w = jnp.asarray(rng.standard_normal((K, N)), jnp.float32)
    return x, w


# (M, K, N, block_k): block_k is the group (int8 groups are whole blocks)
@pytest.mark.parametrize("M,K,N,bk", [(8, 512, 128, 64), (8, 512, 128, 128),
                                      (8, 1024, 128, 512),
                                      (4, 240, 64, 24),    # cuts k16 steps
                                      (4, 96, 64, 8)])     # g < 16
def test_factored_int8_matches_pallas_interpret(M, K, N, bk):
    x, w = _inputs(M + K + bk, M, K, N)
    wq, sc = jsm.quantize_int8(w, block_k=bk)
    ref = jsm.streamed_matmul_int8(x, wq, sc, block_k=bk, interpret=True)
    codes, s = _codes_and_scales("int8", (_t(wq), _t(sc)))
    out = scheduled(_t(x), codes, s, bk)
    _assert_f32_close(out, ref, x, jsm.dequant_int8(wq, sc))


@pytest.mark.parametrize("M,K,N,group,bk", [(8, 512, 128, 128, None),
                                            (8, 512, 128, 64, 128),
                                            (4, 240, 64, 24, 120),
                                            (4, 96, 64, 8, 32)])
def test_factored_int4_matches_pallas_interpret(M, K, N, group, bk):
    x, w = _inputs(M + K + group, M, K, N)
    q = jsm.quantize_int4(w, group_size=group)
    ref = jsm.streamed_matmul_int4(x, *q, block_m=M, block_n=64,
                                   block_k=bk, interpret=True)
    codes, s = _codes_and_scales("int4", tuple(_t(a) for a in q))
    out = scheduled(_t(x), codes, s, group)
    _assert_f32_close(out, ref, x, jsm.dequant_int4(*q))


@pytest.mark.parametrize("mode", ["int8", "int4"])
@pytest.mark.parametrize("M,K,N,g0", [(4, 700, 96, 128),   # 6 groups of 117
                                      (3, 250, 70, 128),   # 2 of 125
                                      (2, 100, 33, 12),    # 9 of 12, ragged
                                      (2, 4864, 64, 128),  # 38 splits
                                      (1, 4864, 896, 64)])  # g 64, 19 splits
def test_factored_ragged_groups_match_dequant_matmul(mode, M, K, N, g0):
    """Ragged groups, which the Pallas kernels reject: the factored form
    equals the reference's dequantiser and an f32 matmul."""
    x, w = _inputs(M * K + N + g0, M, K, N)
    if mode == "int8":
        q = jsm.quantize_int8(w, block_k=g0)
        wd = jsm.dequant_int8(*q)
    else:
        q = jsm.quantize_int4(w, group_size=g0)
        wd = jsm.dequant_int4(*q)
    codes, s = _codes_and_scales(mode, tuple(_t(a) for a in q))
    G = s.shape[0]
    out = scheduled(_t(x), codes, s, -(-K // G))
    _assert_f32_close(out, x @ wd, x, wd)


@pytest.mark.parametrize("M,K,N,g", [(3, 700, 129, 117), (2, 250, 70, 125),
                                     (2, 4864, 64, 128), (2, 4864, 896, 128),
                                     (2, 200, 80, 5), (2, 64, 64, 1),
                                     (2, 96, 32, 16), (2, 130, 48, 3),
                                     (2, 5120, 40, 24)])
def test_schedule_takes_every_row_once_with_its_groups_scale(M, K, N, g):
    """On integers and power-of-two scales every sum is exact in f64, so
    the kernel's walk (splits, steps cut by groups, flushes) must give
    exactly sum_k x[k] * codes[k] * s[k // g]: each row once, scaled by its
    own group's scale."""
    rng = np.random.default_rng(K + N + g)
    G = -(-K // g)
    x = torch.from_numpy(rng.integers(-4, 5, (M, K)).astype(np.float64))
    codes = torch.from_numpy(rng.integers(-127, 128, (K, N))
                             .astype(np.float64))
    s = torch.from_numpy(2.0 ** rng.integers(-12, 4, (G, N)))
    want = x @ (codes * s[torch.arange(K) // g])
    got = scheduled(x, codes, s, g, dtype=torch.float64)
    assert torch.equal(got, want)


def test_codes_are_exact_in_bf16():
    """Every int8 code and every int4 q - z is an integer bf16 holds, and
    a bf16 x times one is exact in f32 (8 + 7 significant bits < 24)."""
    int8 = torch.arange(-127, 128, dtype=torch.float32)
    assert torch.equal(int8.to(torch.bfloat16).to(torch.float32), int8)
    q, z = torch.meshgrid(torch.arange(16), torch.arange(16), indexing="ij")
    diff = (q - z).to(torch.float32).flatten()
    assert torch.equal(diff.to(torch.bfloat16).to(torch.float32), diff)
    rng = np.random.default_rng(0)
    xs = np.concatenate([rng.standard_normal(4096) * 10.0 ** e
                         for e in (-20, -3, 0, 3, 20)])
    x = torch.from_numpy(xs).to(torch.bfloat16).to(torch.float32)
    for codes in (int8, diff):
        prod32 = x[:, None] * codes[None, :]
        prod64 = x.double()[:, None] * codes.double()[None, :]
        assert torch.equal(prod32.double(), prod64)


def test_quant_kernel_variant_by_dtype():
    assert km.kernel_variant(torch.bfloat16) == "mma"
    assert km.kernel_variant(torch.float32) == "fma"
    for fn in (km.streamed_matmul_int8, km.streamed_matmul_int4):
        assert set(fn.variant_launches) == {"mma", "fma"}


def test_quant_cpu_calls_do_not_count_as_variant_launches():
    q8 = km.quantize_int8(torch.ones(8, 4))
    q4 = km.quantize_int4(torch.ones(8, 4))
    before = (dict(km.streamed_matmul_int8.variant_launches),
              dict(km.streamed_matmul_int4.variant_launches))
    for dtype in (torch.bfloat16, torch.float32):
        km.streamed_matmul_int8(torch.ones(2, 8, dtype=dtype), *q8)
        km.streamed_matmul_int4(torch.ones(2, 8, dtype=dtype), *q4)
    assert (km.streamed_matmul_int8.variant_launches,
            km.streamed_matmul_int4.variant_launches) == before


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
    """The wrappers' CUDA path on CPU tensors, with both libraries
    recording instead of launching."""
    mma = _Recorder(km.LIBRARY_MMA.symbols)
    fma = _Recorder(km.LIBRARY.symbols)
    monkeypatch.setattr(km, "LIBRARY_MMA", mma)
    monkeypatch.setattr(km, "LIBRARY", fma)
    monkeypatch.setattr(km, "on_cpu", lambda *a: False)
    # CPU tensors have no device index; the wrapper compares it with this
    monkeypatch.setattr(torch.cuda, "current_device", lambda: None)
    monkeypatch.setattr(km, "_raw_stream", lambda dev: 7)
    monkeypatch.setattr(km, "_COUNTERS", {})
    return mma, fma


@pytest.mark.parametrize("mode", ["int8", "int4"])
@pytest.mark.parametrize("K,N", [(896, 4864), (4864, 896), (250, 70)])
def test_quant_split_plan_whatever_m(recorded, mode, K, N):
    """bf16 x: one launch per row slice of 256, each with the split of
    ``split_plan(K, N)`` and the group size from the shapes, whatever M;
    the arguments match the entry point's declared types; the counts go
    to ``mma``."""
    mma, fma = recorded
    w = torch.randn(K, N)
    q = km.quantize_int8(w, block_k=128) if mode == "int8" \
        else km.quantize_int4(w, group_size=128)
    fn = km.streamed_matmul_int8 if mode == "int8" \
        else km.streamed_matmul_int4
    G = q[1].shape[0]
    S, k_split = km.split_plan(K, N)
    before = (fn.launches, dict(fn.variant_launches))
    for M in (1, 4, 16, 17, 256, 600):
        x = torch.ones(M, K, dtype=torch.bfloat16)
        mma.calls.clear()
        fn(x, *q)
        name = f"k{2 if mode == 'int8' else 3}_streamed_matmul_{mode}_bf16_mma"
        assert [c[0] for c in mma.calls] == [name] * len(km.row_slices(M))
        for (r0, r1), (_, args) in zip(km.row_slices(M), mma.calls):
            assert len(args) == len(km.LIBRARY_MMA.symbols[name])
            assert args[0] == x.data_ptr() + 2 * r0 * K
            nq = len(q)
            assert list(args[1:1 + nq]) == [t.data_ptr() for t in q]
            ws_ptr, counters = args[2 + nq:4 + nq]
            assert (ws_ptr is None) == (S == 1) == (counters is None)
            assert args[4 + nq:] == (r1 - r0, N, K, -(-K // G), k_split, 7)
    assert fma.calls == []
    assert fn.launches == before[0] + 6
    assert fn.variant_launches == {"mma": before[1]["mma"] + 6,
                                   "fma": before[1]["fma"]}


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_quant_f32_takes_the_cuda_core_kernel(recorded, mode):
    mma, fma = recorded
    K, N = 250, 70
    w = torch.randn(K, N)
    q = km.quantize_int8(w, block_k=128) if mode == "int8" \
        else km.quantize_int4(w, group_size=128)
    fn = km.streamed_matmul_int8 if mode == "int8" \
        else km.streamed_matmul_int4
    before = dict(fn.variant_launches)
    x = torch.ones(300, K)
    fn(x, *q)
    name = f"k{2 if mode == 'int8' else 3}_streamed_matmul_{mode}_f32"
    assert mma.calls == [] and [c[0] for c in fma.calls] == [name]
    args = fma.calls[0][1]
    assert len(args) == len(km.LIBRARY.symbols[name])
    assert args[0] == x.data_ptr() and args[-5:] == (300, N, K, 125, 7)
    assert fn.variant_launches == {"mma": before["mma"],
                                   "fma": before["fma"] + 1}
