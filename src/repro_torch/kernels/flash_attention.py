"""K4 — flash attention with VLMOpt's Q-chunk knob.

``flash_attention(q, k, v, causal=, block_q=, block_k=)`` computes what the
reference's Pallas ``flash_attention`` computes: per head, the online
softmax over the keys with q, k and v upcast to f32, f32 scores times
``hd ** -0.5``, the causal mask ``kpos <= qpos`` (both counted from 0) and
the result in ``q.dtype``; query head h reads kv head ``h // (H // KV)``.
On a CUDA tensor the wrapper launches a hand-written Hopper kernel on the
current stream (or raises); on a CPU tensor it computes the plain version
``kernels/ref.py::flash_attention_ref``. There is no fallback from one to
the other. Two kernels, chosen by ``kernel_variant`` from the dtype, the
head dim, the strides and the pointers' alignment alone (never from a
failure): ``"mma"``, the tensor-core kernel of
``csrc/flash_attention_mma.cu`` (bf16 with hd a multiple of 8 and 16-byte
aligned rows: every shape the model path gives it), and ``"fma"``, the
f32 CUDA-core kernel of ``csrc/flash_attention.cu`` (f32, and bf16 at
any other shape). The mma kernel rounds p to bf16 before ``p @ v``.

``block_q`` and ``block_k`` are the reference's Q-chunk and KV-chunk. The
kernels tile the query axis by their own fixed rows (64 on the CUDA cores,
128 on the tensor cores): a row's sums never depend on the block that
holds it, so ``block_q`` could change no result and is only checked (any
positive value runs). The key axis is cut into
chunks of ``block_k`` keys, each walked in fixed tiles. Unlike the Pallas
kernel, ragged lengths are masked (rows past Tq are not stored, keys past
Tk weigh 0), so no length has to divide a chunk. Any head dim up to 128
runs; the inputs need a contiguous head dim and nothing else.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.device import on_cpu
from repro_torch.kernels._build import CudaLibrary
from repro_torch.kernels.ref import flash_attention_ref

MAX_HEAD_DIM = 128

_P, _I = ctypes.c_void_p, ctypes.c_int
_STRIDES = ctypes.c_longlong * 12
# q k v o B H KV Tq Tk hd strides causal block_k scale stream
_K4_ARGS = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
            ctypes.POINTER(ctypes.c_longlong), _I, _I, ctypes.c_float, _P]
_CSRC = Path(__file__).resolve().parent / "csrc"
LIBRARY = CudaLibrary(
    _CSRC / "flash_attention.cu",
    {"k4_flash_attention_bf16": _K4_ARGS,
     "k4_flash_attention_f32": _K4_ARGS})
LIBRARY_MMA = CudaLibrary(_CSRC / "flash_attention_mma.cu",
                          {"k4_flash_attention_bf16_mma": _K4_ARGS})
_SUFFIX = {torch.bfloat16: "bf16", torch.float32: "f32"}
_INT_MAX = 2 ** 31 - 1
_GRID_Y_MAX = 65535


def check_inputs(q, k, v, block_q, block_k):
    """Shapes, types and layouts the kernel takes; returns
    (B, H, KV, Tq, Tk, hd)."""
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError("flash_attention takes q (B, H, Tq, hd) and k, v "
                         "(B, KV, Tk, hd)")
    B, H, Tq, hd = q.shape
    KV, Tk = k.shape[1], k.shape[2]
    if tuple(k.shape) != (B, KV, Tk, hd) or v.shape != k.shape:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} do not "
                         "match")
    if KV < 1 or H % KV:
        raise ValueError(f"flash_attention: H={H} is not a multiple of "
                         f"KV={KV}")
    if not 1 <= hd <= MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: head dim {hd} outside 1.."
                         f"{MAX_HEAD_DIM}")
    if block_q < 1 or block_k < 1:
        raise ValueError(f"flash_attention: block_q={block_q}, "
                         f"block_k={block_k} must be positive")
    if q.dtype not in _SUFFIX or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention takes bf16 or f32 of one dtype, "
                         f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("flash_attention takes a contiguous head dim")
    if B * H > _GRID_Y_MAX or max(Tq, Tk) > _INT_MAX:
        raise ValueError(f"flash_attention: B*H={B * H} or a length "
                         "exceeds the launch grid")
    return B, H, KV, Tq, Tk, hd


def kernel_variant(q, k, v, out) -> str:
    """``"mma"`` where the tensor-core kernel takes the call: bf16, a head
    dim that is a multiple of 8, every (batch, head, position) stride of
    q, k, v and out a multiple of 8 elements and 16-byte aligned data
    pointers, so that every row moves as 16-byte copies. Else ``"fma"``,
    the CUDA-core kernel. A pure function of these properties."""
    ts = (q, k, v, out)
    if q.dtype == torch.bfloat16 and q.shape[-1] % 8 == 0 \
            and all(s % 8 == 0 for t in ts for s in t.stride()[:3]) \
            and all(t.data_ptr() % 16 == 0 for t in ts):
        return "mma"
    return "fma"


def launch(q, k, v, out, *, causal, block_q, block_k):
    """Run K4 into ``out`` (q's shape and dtype, any strides with a
    contiguous head dim) on the current stream; counts one launch.
    ``flash_attention`` and ``ops.flash_attention_bthd`` call it."""
    B, H, KV, Tq, Tk, hd = check_inputs(q, k, v, block_q, block_k)
    if out.shape != q.shape or out.dtype != q.dtype or out.stride(-1) != 1 \
            or out.device != q.device:
        raise ValueError("flash_attention: out does not match q")
    if Tk == 0:
        raise ValueError("flash_attention: no keys")
    if B * H * Tq == 0:
        return out
    strides = _STRIDES(*(s for t in (q, k, v, out) for s in t.stride()[:3]))
    variant = kernel_variant(q, k, v, out)
    fn = LIBRARY_MMA.lib().k4_flash_attention_bf16_mma if variant == "mma" \
        else getattr(LIBRARY.lib(), f"k4_flash_attention_{_SUFFIX[q.dtype]}")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                B, H, KV, Tq, Tk, hd, strides, int(bool(causal)),
                block_k, hd ** -0.5, stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: "
                           f"cudaError {rc} at q {tuple(q.shape)}, k "
                           f"{tuple(k.shape)}")
    flash_attention.launches += 1
    flash_attention.variant_launches[variant] += 1
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, block_q: int = 128,
                    block_k: int = 128) -> torch.Tensor:
    """K4. q: (B, H, Tq, hd); k, v: (B, KV, Tk, hd), H % KV == 0, bf16 or
    f32. Returns (B, H, Tq, hd) in ``q.dtype``. Launch count:
    ``flash_attention.launches``, and per kernel
    ``flash_attention.variant_launches`` (``kernel_variant``)."""
    cpu = on_cpu("flash_attention", q, k, v)
    check_inputs(q, k, v, block_q, block_k)
    if cpu:
        return flash_attention_ref(q, k, v, causal=causal)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    return launch(q, k, v, out, causal=causal, block_q=block_q,
                  block_k=block_k)


flash_attention.launches = 0
flash_attention.variant_launches = {"mma": 0, "fma": 0}
