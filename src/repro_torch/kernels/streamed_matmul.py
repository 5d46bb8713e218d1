"""K1, K2, K3 — the streamed matmuls — and the host-side quantisers.

``streamed_matmul(x, w)`` computes ``(M, K) @ (K, N)`` with both operands
upcast to f32, an f32 sum over K and the result in ``x.dtype`` — what the
reference's Pallas ``streamed_matmul`` computes. ``streamed_matmul_int8``
and ``streamed_matmul_int4`` compute the same product with the weight
stored as grouped int8 codes (``quantize_int8``) or packed int4 codes
(``quantize_int4``), dequantised inside the kernel. On a CUDA tensor each
wrapper launches its hand-written Hopper kernel in
``csrc/streamed_matmul.cu`` on the current stream (or raises); on a CPU
tensor it computes the plain version in ``kernels/ref.py``. There is no
fallback from one to the other.

Unlike the Pallas kernels, the CUDA kernels mask ragged tiles and take
ragged quantisation groups, so any (M, K, N) and any group count are
accepted: the dense FFN of qwen2-0.5b (d=896, f=4864) and the smoke widths
(d=56, f=112) both run through them.

Grouping convention shared by every quantiser here, as in the reference:
for a (K, N) matrix and a nominal group size ``g0``, the K axis is split
into ``G = ceil(K / g0)`` balanced groups of ``g = ceil(K / G)`` rows
(edge-padded up to ``G * g`` before quantisation; the padding replicates
the last row so group min/max and abs-max are unchanged, then the
quantised rows are sliced back to K). Every consumer recovers ``g`` from
the shapes alone.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.device import on_cpu
from repro_torch.kernels._build import CudaLibrary
from repro_torch.kernels.ref import (streamed_matmul_int4_ref,
                                     streamed_matmul_int8_ref,
                                     streamed_matmul_ref)

# Nominal quantisation group size along K (AWQ-style); balanced groups of
# ceil(K / ceil(K / GROUP_SIZE)) rows are derived from it per matrix. The
# graph prices quantised weights with it (core/graphing.py).
GROUP_SIZE = 128


def _balanced_groups(K, g0):
    """(G, g): G balanced groups of g rows covering K (g*G >= K, g <= g0)."""
    G = -(-K // g0)
    return G, -(-K // G)


# ------------------------------------------------------------ quantisers
def _f32(value: float, like: torch.Tensor) -> torch.Tensor:
    """An f32 constant as a 0-dim tensor on ``like``'s device. On CUDA,
    PyTorch divides by a Python scalar as a multiply by its reciprocal,
    which can differ from true division by one ulp; a device tensor keeps
    the division exact, as on the CPU and in the reference."""
    return torch.tensor(value, dtype=torch.float32, device=like.device)


def _grouped_f32(w: torch.Tensor, g0: int):
    """w (K, N) as f32 groups (G, g, N), edge-padded to G * g rows."""
    K, N = w.shape
    G, g = _balanced_groups(K, g0)
    wf = w.to(torch.float32)
    if G * g != K:
        wf = torch.cat([wf, wf[-1:].expand(G * g - K, N)])
    return wf.reshape(G, g, N), G, g


def quantize_int8(w: torch.Tensor, block_k: int = 512):
    """Per-(k-group, column) symmetric int8 quantisation. Returns
    ``(q (K, N) int8, scales (G, 1, N) f32)``, byte-equal to the
    reference's on the same f32 or bf16 input."""
    K, N = w.shape
    wt, G, g = _grouped_f32(w, block_k)
    scale = torch.amax(torch.abs(wt), dim=1, keepdim=True) / _f32(127, wt)
    scale = torch.maximum(scale, _f32(1e-8, wt))
    # torch.round rounds half to even, as jnp.round
    q = torch.clamp(torch.round(wt / scale), -127, 127).to(torch.int8)
    return q.reshape(G * g, N)[:K], scale


def quantize_int4(w: torch.Tensor, group_size: int = GROUP_SIZE):
    """AWQ-style asymmetric int4 grouped quantisation with nibble packing.

    Per balanced k-group and output column: ``scale = (max - min) / 15``,
    ``zero = round(-min / scale)`` in [0, 15], codes
    ``q = round(w / scale) + zero`` in [0, 15], all with the f32 scale; the
    scale is then stored as fp16, which dequantisation uses. Two
    consecutive K rows pack into one byte, low nibble = even row. Returns
    ``(packed (K//2, N) uint8, scales (G, N) fp16, zeros (G, N) uint8)``.
    """
    K, N = w.shape
    if K % 2:
        raise ValueError(
            f"int4 nibble packing needs an even reduction dim, got K={K}")
    wt, G, g = _grouped_f32(w, group_size)
    wmin = torch.amin(wt, dim=1)                     # (G, N)
    wmax = torch.amax(wt, dim=1)
    scale = torch.maximum((wmax - wmin) / _f32(15, wt), _f32(1e-8, wt))
    zero = torch.clamp(torch.round(-wmin / scale), 0.0, 15.0)
    q = torch.clamp(torch.round(wt / scale[:, None, :]) + zero[:, None, :],
                    0, 15)
    q = q.reshape(G * g, N)[:K].to(torch.uint8)
    packed = q[0::2] | (q[1::2] << 4)
    return packed, scale.to(torch.float16), zero.to(torch.uint8)


def dequant_int8(w_q: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`quantize_int8`; f32 result. Accepts leading batch
    dims: ``w_q (..., K, N)``, ``scales (..., G, 1, N)``."""
    K, N = w_q.shape[-2:]
    lead = tuple(w_q.shape[:-2])
    G = scales.shape[-3]
    g = -(-K // G)
    wf = w_q.to(torch.float32)
    if G * g != K:
        wf = torch.nn.functional.pad(wf, (0, 0, 0, G * g - K))
    w = wf.reshape(lead + (G, g, N)) * scales.to(torch.float32)
    return w.reshape(lead + (G * g, N))[..., :K, :]


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """(..., K//2, N) packed bytes -> (..., K, N) uint8 codes in [0, 15]."""
    lead = tuple(packed.shape[:-2])
    Kh, N = packed.shape[-2:]
    lo = packed & 0xF
    hi = packed >> 4
    return torch.stack([lo, hi], dim=-2).reshape(lead + (2 * Kh, N))


def dequant_int4(packed: torch.Tensor, scales: torch.Tensor,
                 zeros: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`quantize_int4`; f32 result. Accepts leading batch
    dims: ``packed (..., K//2, N)``, ``scales``/``zeros (..., G, N)``."""
    lead = tuple(packed.shape[:-2])
    K, N = 2 * packed.shape[-2], packed.shape[-1]
    G = scales.shape[-2]
    g = -(-K // G)
    q = unpack_int4(packed).to(torch.float32)
    if G * g != K:
        q = torch.nn.functional.pad(q, (0, 0, 0, G * g - K))
    qt = q.reshape(lead + (G, g, N))
    s = scales.to(torch.float32)[..., :, None, :]
    z = zeros.to(torch.float32)[..., :, None, :]
    return ((qt - z) * s).reshape(lead + (G * g, N))[..., :K, :]


# ------------------------------------------------------------ kernels
_P, _I = ctypes.c_void_p, ctypes.c_int
_K1_ARGS = [_P, _P, _P, _I, _I, _I, _P]            # x w out M N K stream
_K2_ARGS = [_P, _P, _P, _P, _I, _I, _I, _I, _P]    # x q s out M N K g
_K3_ARGS = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P]  # x p s z out M N K g
LIBRARY = CudaLibrary(
    Path(__file__).resolve().parent / "csrc" / "streamed_matmul.cu",
    {"k1_streamed_matmul_bf16": _K1_ARGS,
     "k1_streamed_matmul_f32": _K1_ARGS,
     "k2_streamed_matmul_int8_bf16": _K2_ARGS,
     "k2_streamed_matmul_int8_f32": _K2_ARGS,
     "k3_streamed_matmul_int4_bf16": _K3_ARGS,
     "k3_streamed_matmul_int4_f32": _K3_ARGS})
_SUFFIX = {torch.bfloat16: "bf16", torch.float32: "f32"}
_INT_MAX = 2 ** 31 - 1


def _check(name, x, w, K_w, N):
    """Shared checks of x against a (K_w, N) weight; returns (M, K, N)."""
    if x.dtype not in _SUFFIX:
        raise ValueError(f"{name} takes bf16 or f32 activations, got "
                         f"{x.dtype}")
    if x.ndim != 2 or w.ndim != 2 or x.shape[1] != K_w:
        raise ValueError(f"{name}: shapes {tuple(x.shape)} @ "
                         f"{tuple(w.shape)} do not multiply")
    M, K = x.shape
    if max(M, N, K) > _INT_MAX:
        raise ValueError(f"{name}: a dimension exceeds int32")
    return M, K, N


def _launch(name, fn_name, x, ptrs, M, N, K, extra=()):
    """Allocate the output and launch ``fn_name`` on the current stream."""
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    if M == 0 or N == 0:
        return out, False
    fn = getattr(LIBRARY.lib(), fn_name)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(x.data_ptr(), *(t.data_ptr() for t in ptrs),
                out.data_ptr(), M, N, K, *extra, stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {rc} "
                           f"at M={M} K={K} N={N}")
    return out, True


def streamed_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """K1. x: (M, K) activations; w: (K, N) weights of x's dtype. Returns
    (M, N) in ``x.dtype``. Launch count: ``streamed_matmul.launches``."""
    if on_cpu("streamed_matmul", x, w):
        return streamed_matmul_ref(x, w)
    if w.dtype != x.dtype:
        raise ValueError(f"streamed_matmul takes bf16 or f32 of one dtype, "
                         f"got x {x.dtype}, w {w.dtype}")
    M, K, N = _check("streamed_matmul", x, w, w.shape[0], w.shape[-1])
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("streamed_matmul takes contiguous row-major x, w")
    out, launched = _launch("streamed_matmul",
                            f"k1_streamed_matmul_{_SUFFIX[x.dtype]}", x,
                            (w,), M, N, K)
    streamed_matmul.launches += launched
    return out


def streamed_matmul_int8(x: torch.Tensor, w_q: torch.Tensor,
                         scales: torch.Tensor) -> torch.Tensor:
    """K2. x: (M, K) bf16 or f32; w_q: (K, N) int8 codes; scales: (G, 1, N)
    f32 (``quantize_int8``). Returns ``x.f32 @ dequant_int8(w_q, scales)``
    in ``x.dtype``. Launch count: ``streamed_matmul_int8.launches``."""
    name = "streamed_matmul_int8"
    if on_cpu(name, x, w_q, scales):
        return streamed_matmul_int8_ref(x, w_q, scales)
    M, K, N = _check(name, x, w_q, w_q.shape[0], w_q.shape[-1])
    if w_q.dtype != torch.int8 or scales.dtype != torch.float32:
        raise ValueError(f"{name} takes int8 codes and f32 scales, got "
                         f"{w_q.dtype}, {scales.dtype}")
    if scales.ndim != 3 or scales.shape[1] != 1 or scales.shape[2] != N \
            or not 1 <= scales.shape[0] <= max(K, 1):
        raise ValueError(f"{name}: scales {tuple(scales.shape)} do not "
                         f"group a ({K}, {N}) weight as (G, 1, N)")
    if not all(t.is_contiguous() for t in (x, w_q, scales)):
        raise ValueError(f"{name} takes contiguous x, w_q, scales")
    g = max(-(-K // scales.shape[0]), 1)
    out, launched = _launch(
        name, f"k2_streamed_matmul_int8_{_SUFFIX[x.dtype]}", x,
        (w_q, scales), M, N, K, extra=(g,))
    streamed_matmul_int8.launches += launched
    return out


def streamed_matmul_int4(x: torch.Tensor, w_packed: torch.Tensor,
                         scales: torch.Tensor,
                         zeros: torch.Tensor) -> torch.Tensor:
    """K3. x: (M, K) bf16 or f32; w_packed: (K//2, N) uint8, two int4 codes
    per byte (low nibble = even K row); scales: (G, N) fp16; zeros: (G, N)
    uint8 (``quantize_int4``). Returns ``x.f32 @ dequant_int4(...)`` in
    ``x.dtype``; any group count, ragged or odd groups included. Launch
    count: ``streamed_matmul_int4.launches``."""
    name = "streamed_matmul_int4"
    if on_cpu(name, x, w_packed, scales, zeros):
        return streamed_matmul_int4_ref(x, w_packed, scales, zeros)
    M, K, N = _check(name, x, w_packed, 2 * w_packed.shape[0],
                     w_packed.shape[-1])
    if (w_packed.dtype, scales.dtype, zeros.dtype) != \
            (torch.uint8, torch.float16, torch.uint8):
        raise ValueError(f"{name} takes uint8 codes, fp16 scales and uint8 "
                         f"zeros, got {w_packed.dtype}, {scales.dtype}, "
                         f"{zeros.dtype}")
    if scales.ndim != 2 or scales.shape[1] != N \
            or zeros.shape != scales.shape \
            or not 1 <= scales.shape[0] <= max(K, 1):
        raise ValueError(f"{name}: scales {tuple(scales.shape)} / zeros "
                         f"{tuple(zeros.shape)} do not group a ({K}, {N}) "
                         "weight as (G, N)")
    if not all(t.is_contiguous() for t in (x, w_packed, scales, zeros)):
        raise ValueError(f"{name} takes contiguous x, w_packed, scales, "
                         "zeros")
    g = max(-(-K // scales.shape[0]), 1)
    out, launched = _launch(
        name, f"k3_streamed_matmul_int4_{_SUFFIX[x.dtype]}", x,
        (w_packed, scales, zeros), M, N, K, extra=(g,))
    streamed_matmul_int4.launches += launched
    return out


streamed_matmul.launches = 0
streamed_matmul_int8.launches = 0
streamed_matmul_int4.launches = 0
