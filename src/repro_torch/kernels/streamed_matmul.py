"""K1, the streamed matmul, and the host-side quantisation constants.

``streamed_matmul(x, w)`` computes ``(M, K) @ (K, N)`` with both operands
upcast to f32, an f32 sum over K and the result in ``x.dtype`` — what the
reference's Pallas ``streamed_matmul`` computes. On a CUDA tensor it
launches the hand-written Hopper kernel in ``csrc/streamed_matmul.cu`` on
the current stream (or raises); on a CPU tensor it computes the plain
version in ``kernels/ref.py``. There is no fallback from one to the other.

Unlike the Pallas kernel, the CUDA kernel masks ragged tiles itself, so any
(M, K, N) is accepted: the dense FFN of qwen2-0.5b (d=896, f=4864) and the
smoke widths (d=56, f=112) both run through it.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels._build import CudaLibrary
from repro_torch.kernels.ref import streamed_matmul_ref

# Nominal quantisation group size along K (AWQ-style); balanced groups of
# ceil(K / ceil(K / GROUP_SIZE)) rows are derived from it per matrix. The
# graph prices quantised weights with it (core/graphing.py).
GROUP_SIZE = 128


def _balanced_groups(K, g0):
    """(G, g): G balanced groups of g rows covering K (g*G >= K, g <= g0)."""
    G = -(-K // g0)
    return G, -(-K // G)


_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
         ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
LIBRARY = CudaLibrary(
    Path(__file__).resolve().parent / "csrc" / "streamed_matmul.cu",
    {"k1_streamed_matmul_bf16": _ARGS, "k1_streamed_matmul_f32": _ARGS})
_ENTRY = {torch.bfloat16: "k1_streamed_matmul_bf16",
          torch.float32: "k1_streamed_matmul_f32"}
_INT_MAX = 2 ** 31 - 1


def streamed_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: (M, K) activations; w: (K, N) weights. Returns (M, N) in
    ``x.dtype``. Launch count: ``streamed_matmul.launches``."""
    if x.device.type == "cpu" and w.device.type == "cpu":
        return streamed_matmul_ref(x, w)
    if x.device.type != "cuda" or w.device.type != "cuda":
        raise ValueError(f"streamed_matmul: x on {x.device}, w on "
                         f"{w.device}; both must be on the CPU or on one "
                         "CUDA device")
    if not torch.cuda.is_available():
        raise RuntimeError("streamed_matmul: CUDA tensor given but CUDA is "
                           "not available")
    if x.device != w.device:
        raise ValueError(f"streamed_matmul: x on {x.device}, w on {w.device}")
    if x.dtype not in _ENTRY or w.dtype != x.dtype:
        raise ValueError(f"streamed_matmul takes bf16 or f32 of one dtype, "
                         f"got x {x.dtype}, w {w.dtype}")
    if x.ndim != 2 or w.ndim != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"streamed_matmul: shapes {tuple(x.shape)} @ "
                         f"{tuple(w.shape)} do not multiply")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("streamed_matmul takes contiguous row-major x, w")
    M, K = x.shape
    N = w.shape[1]
    if max(M, N, K) > _INT_MAX:
        raise ValueError("streamed_matmul: a dimension exceeds int32")
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    if M == 0 or N == 0:
        return out
    fn = getattr(LIBRARY.lib(), _ENTRY[x.dtype])
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(x.data_ptr(), w.data_ptr(), out.data_ptr(), M, N, K, stream)
    if rc != 0:
        raise RuntimeError(f"streamed_matmul kernel launch failed: "
                           f"cudaError {rc} at M={M} K={K} N={N}")
    streamed_matmul.launches += 1
    return out


streamed_matmul.launches = 0
