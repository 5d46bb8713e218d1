"""K3's yardstick in chip_smoke.py, on the CPU: the conversion of K3's
operands to ``torch._weight_int4pack_mm``'s.

K3 computes x @ w with w = (q - z) s (``quantize_int4``: packed (K/2, N)
uint8 with the even row in the low nibble, fp16 s and integer z per group
of K rows and column). The op computes w = (q - 8) s' + z' from codes in
its own (N, K/2) layout (the even k in the high nibble) and
``qScaleAndZeros (G, N, 2)``, so ``int4pack_operands`` gives s' = s and
z' = (8 - z) s in bf16.

- Over full and ragged groups (g of 128, 117, 125, 64, 3), the weight the
  op's formula gives from the converted operands equals ``dequant_int4``
  within bf16's rounding of s' and z' (2^-8 of each term, plus f32's of the
  products); the codes read with the nibbles the other way round break
  that limit.
- Where this torch has the op's CPU twin (``_convert_weight_to_int4pack_
  for_cpu``, ``_weight_int4pack_mm_for_cpu``: codes as (N, K) int32, the
  same ``qScaleAndZeros``), its product at chip_smoke's timed K3 widths
  (K of 896, 768, 2048 at narrow N) equals K3's plain version within 2e-2.
  The CUDA op itself runs only on the card (chip_smoke.py, phase 2).
- ``int4pack_unfit`` takes every shape chip_smoke times K3 at, and names
  what the op cannot take.
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels import ref as kref
from repro_torch.kernels import streamed_matmul as sm

torch.set_num_threads(1)

BF16_UNIT = 2.0 ** -8      # bf16 rounds to 8 significant bits
F32_UNIT = 2.0 ** -24
# (K, N, nominal group): full groups of 128 and 64, ragged ones of 117
# (K = 700) and 125 (K = 250, a byte's nibbles in two groups), odd g = 3
SHAPES = ((256, 16, 128), (896, 24, 128), (700, 40, 128), (250, 24, 128),
          (192, 8, 64), (130, 8, 3))
# chip_smoke's timed K3 shapes (K, N)
TIMED = ((896, 4864), (4864, 896), (2048, 768), (768, 2048), (5120, 17408),
         (17408, 5120))


def chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def quantised(K, N, group, seed):
    rng = np.random.default_rng(seed)
    w = torch.from_numpy(rng.standard_normal((K, N), np.float32)) / K ** 0.5
    return sm.quantize_int4(w, group_size=group)


def decode(codes, high_even=True):
    """(N, K/2) bytes -> (N, K) codes, the even k in the high nibble (the
    op's layout) or, with ``high_even`` False, in the low one."""
    hi, lo = codes >> 4, codes & 0xF
    even, odd = (hi, lo) if high_even else (lo, hi)
    return torch.stack([even, odd], dim=-1).reshape(codes.shape[0], -1)


def op_weight(codes, sz, g, high_even=True):
    """(K, N) f64: the op's (q - 8) s' + z' from the converted operands."""
    q = decode(codes, high_even).t().to(torch.float64)
    rows = torch.arange(q.shape[0]) // g
    s, z = sz[..., 0].to(torch.float64), sz[..., 1].to(torch.float64)
    return (q - 8) * s[rows] + z[rows]


def rounding_limit(packed, scales, zeros):
    """bf16's rounding of s' and z' (2^-8 of each term), plus f32's of
    (8 - z) s before it and of dequant_int4's (q - z) s."""
    K = 2 * packed.shape[0]
    g = -(-K // scales.shape[0])
    rows = torch.arange(K) // g
    q = sm.unpack_int4(packed).to(torch.float64)
    s = scales.to(torch.float64)[rows]
    z = zeros.to(torch.float64)[rows]
    return (BF16_UNIT * ((q - 8).abs() * s + (8 - z).abs() * s)
            + 2 * F32_UNIT * ((8 - z).abs() * s + (q - z).abs() * s))


@pytest.mark.parametrize("K,N,group", SHAPES)
def test_converted_operands_give_k3s_weight(K, N, group):
    cs = chip_smoke()
    packed, scales, zeros = quantised(K, N, group, seed=K + N)
    codes, sz, g = cs.int4pack_operands(packed, scales, zeros)
    G = scales.shape[0]
    assert codes.shape == (N, K // 2) and codes.dtype == torch.uint8
    assert sz.shape == (G, N, 2) and sz.dtype == torch.bfloat16
    assert codes.is_contiguous() and sz.is_contiguous()
    assert g == -(-K // G)
    # the codes are K3's, moved and nothing else
    assert torch.equal(decode(codes).t(), sm.unpack_int4(packed))
    want = sm.dequant_int4(packed, scales, zeros).to(torch.float64)
    lim = rounding_limit(packed, scales, zeros)
    err = (op_weight(codes, sz, g) - want).abs()
    assert (err <= lim).all(), f"{(err / lim).max().item():.3f}x the limit"
    # the limit has teeth: the nibbles read the other way round break it
    bad = (op_weight(codes, sz, g, high_even=False) - want).abs()
    assert (bad > lim).any()


@pytest.mark.parametrize("K,N", [(896, 64), (768, 32), (2048, 16)])
@pytest.mark.parametrize("M", [1, 4, 64])
def test_cpu_twin_of_the_op_matches_k3s_plain_version(K, N, M):
    if not torch._C._dispatch_has_kernel_for_dispatch_key(
            "aten::_weight_int4pack_mm_for_cpu", "CPU"):
        pytest.skip(f"torch {torch.__version__} has no CPU kernel for "
                    "aten::_weight_int4pack_mm_for_cpu")
    cs = chip_smoke()
    packed, scales, zeros = quantised(K, N, sm.GROUP_SIZE, seed=M + K)
    codes, sz, g = cs.int4pack_operands(packed, scales, zeros)
    assert g == sm.GROUP_SIZE and cs.int4pack_unfit(K, N, g) is None
    w = torch._convert_weight_to_int4pack_for_cpu(
        decode(codes).to(torch.int32), cs.INT4PACK_INNER_K_TILES)
    rng = np.random.default_rng(M)
    x = torch.from_numpy(rng.standard_normal((M, K), np.float32)) \
        .to(torch.bfloat16)
    y = torch._weight_int4pack_mm_for_cpu(x, w, g, sz)
    want = kref.streamed_matmul_int4_ref(x, packed, scales, zeros)
    assert y.shape == want.shape == (M, N) and y.dtype == torch.bfloat16
    cs.check_close(f"int4pack ({M},{K})@({K},{N})", y, want, "bfloat16")


def test_unfit_takes_the_timed_shapes_and_names_the_rest():
    cs = chip_smoke()
    for K, N in TIMED:
        G = -(-K // sm.GROUP_SIZE)
        assert cs.int4pack_unfit(K, N, -(-K // G)) is None, (K, N)
    assert "groups of 117" in cs.int4pack_unfit(700, 128, 117)
    assert "N = 129" in cs.int4pack_unfit(896, 129, 128)
    assert "K = 960" in cs.int4pack_unfit(960, 128, 64)
