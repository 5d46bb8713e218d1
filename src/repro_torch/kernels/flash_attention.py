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

Gradients. When autograd needs one (grad mode on and q, k or v requiring
grad), ``flash_attention`` and ``ops.flash_attention_bthd`` run through
``FlashAttention``, a ``torch.autograd.Function``: its forward is the same
kernel asked for its f32 row logsumexp as well (``lse``, (B, H, Tq); the
output's bits and the launch count are those of the call without it), and
its backward is ``flash_attention_backward``: on a CUDA tensor one of two
hand-written backward kernels, chosen by ``kernel_variant`` as the forward
is (the backward reads q, k, v, the output gradient and lse, not the
output; no atomics, so its bits do not depend on the launch): ``"mma"``,
``csrc/flash_attention_bwd_mma.cu`` (bf16 on the tensor cores, p and ds
rounded to bf16 as the products' operands, f32 sums), and ``"fma"``,
``csrc/flash_attention_bwd.cu`` (f32 sums of exact products on the CUDA
cores: f32, and bf16 at any other shape); on a CPU tensor the plain
``kernels/ref.py::flash_attention_bwd_ref``. Under no grad (serving) the
wrappers take the forward kernel alone, as before.

Counting. Inside ``launch/counting.py``'s ``count_step`` each call of the
forward (``flash_attention``, ``ops.flash_attention_bthd``,
``FlashAttention``) is one unit ``"K4"`` and each backward one unit
``"K4bwd"``, counted by hand (``counting.flash_work``,
``flash_bwd_work``); the outputs (lse included) take the kernel's
layout, contiguous in the caller's layout: empties on fake tensors, the
plain version's results copied in on the CPU, the kernel's on the card;
the backward's f32 D scratch is a temporary (``count_unit``).
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.device import is_fake, needs_grad, on_cpu
from repro_torch.kernels._build import CudaLibrary
from repro_torch.kernels.ref import (flash_attention_bwd_ref,
                                     flash_attention_ref)
from repro_torch.launch import counting

MAX_HEAD_DIM = 128

_P, _I = ctypes.c_void_p, ctypes.c_int
_STRIDES = ctypes.c_longlong * 12
# q k v o lse B H KV Tq Tk hd strides causal block_k scale stream
_K4_ARGS = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
            ctypes.POINTER(ctypes.c_longlong), _I, _I, ctypes.c_float, _P]
# q k v dout lse delta dq dk dv B H KV Tq Tk hd strides causal scale stream
_K4_BWD_ARGS = [_P] * 9 + [_I] * 6 + [ctypes.POINTER(ctypes.c_longlong),
                                      _I, ctypes.c_float, _P]
_BWD_STRIDES = ctypes.c_longlong * 21
_CSRC = Path(__file__).resolve().parent / "csrc"
LIBRARY = CudaLibrary(
    _CSRC / "flash_attention.cu",
    {"k4_flash_attention_bf16": _K4_ARGS,
     "k4_flash_attention_f32": _K4_ARGS})
LIBRARY_MMA = CudaLibrary(_CSRC / "flash_attention_mma.cu",
                          {"k4_flash_attention_bf16_mma": _K4_ARGS})
LIBRARY_BWD = CudaLibrary(
    _CSRC / "flash_attention_bwd.cu",
    {"k4_flash_attention_bwd_bf16": _K4_BWD_ARGS,
     "k4_flash_attention_bwd_f32": _K4_BWD_ARGS})
LIBRARY_BWD_MMA = CudaLibrary(
    _CSRC / "flash_attention_bwd_mma.cu",
    {"k4_flash_attention_bwd_bf16_mma": _K4_BWD_ARGS})
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


def kernel_variant(q, *others) -> str:
    """``"mma"`` where the tensor-core kernel takes the call: bf16, a head
    dim that is a multiple of 8, every (batch, head, position) stride of
    q and ``others`` (the forward: k, v, out; the backward: k, v, dout,
    dq, dk, dv) a multiple of 8 elements and 16-byte aligned data
    pointers, so that every row moves as 16-byte copies. Else ``"fma"``,
    the CUDA-core kernel. A pure function of these properties."""
    ts = (q, *others)
    if q.dtype == torch.bfloat16 and q.shape[-1] % 8 == 0 \
            and all(s % 8 == 0 for t in ts for s in t.stride()[:3]) \
            and all(t.data_ptr() % 16 == 0 for t in ts):
        return "mma"
    return "fma"


def launch(q, k, v, out, *, causal, block_q, block_k, lse=None):
    """Run K4 into ``out`` (q's shape and dtype, any strides with a
    contiguous head dim) on the current stream; counts one launch.
    ``flash_attention`` and ``ops.flash_attention_bthd`` call it. ``lse``:
    a contiguous f32 (B, H, Tq) tensor that also receives each row's
    logsumexp of the scaled scores, or None."""
    B, H, KV, Tq, Tk, hd = check_inputs(q, k, v, block_q, block_k)
    if out.shape != q.shape or out.dtype != q.dtype or out.stride(-1) != 1 \
            or out.device != q.device:
        raise ValueError("flash_attention: out does not match q")
    if Tk == 0:
        raise ValueError("flash_attention: no keys")
    if B * H * Tq == 0:
        return out
    if lse is not None and (lse.shape != (B, H, Tq) or lse.dtype !=
                            torch.float32 or not lse.is_contiguous()
                            or lse.device != q.device):
        raise ValueError("flash_attention: lse must be a contiguous f32 "
                         f"({B}, {H}, {Tq}) tensor on q's device")
    strides = _STRIDES(*(s for t in (q, k, v, out) for s in t.stride()[:3]))
    variant = kernel_variant(q, k, v, out)
    fn = LIBRARY_MMA.lib().k4_flash_attention_bf16_mma if variant == "mma" \
        else getattr(LIBRARY.lib(), f"k4_flash_attention_{_SUFFIX[q.dtype]}")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                None if lse is None else lse.data_ptr(),
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
    if needs_grad(q, k, v):
        return FlashAttention.apply(q, k, v, causal, block_q, block_k, False)
    if counting.active() is not None:
        shape = check_inputs(q, k, v, block_q, block_k)
        return count_unit("K4", counting.flash_work(shape, causal,
                                                  q.element_size()),
                        q, ((q.shape, q.dtype),),
                        lambda: (_forward(q, k, v, causal, block_q,
                                          block_k),))
    return _forward(q, k, v, causal, block_q, block_k)


def count_unit(unit, work, x, like, run, temporaries=()):
    """One K4 or K4-backward call on ``x``'s device inside a count: the
    hand count ``work`` and the outputs as the kernel lays them out,
    contiguous with the (shape, dtype) of ``like``: empties on fake
    tensors; on the CPU the plain version's results (``run()``) copied
    into such tensors, so the step's later ops are the card's; on the card
    ``run()``'s own."""
    with counting.active().unit(unit, work, temporaries, x.device) as done:
        if is_fake(x):
            return done(*(torch.empty(tuple(s), dtype=d, device=x.device)
                          for s, d in like))
        res = run()
        if x.device.type == "cpu":
            res = [torch.empty(tuple(s), dtype=d).copy_(r)
                   for (s, d), r in zip(like, res)]
        return done(*res)


def _forward(q, k, v, causal, block_q, block_k):
    cpu = on_cpu("flash_attention", q, k, v)
    check_inputs(q, k, v, block_q, block_k)
    if cpu:
        return flash_attention_ref(q, k, v, causal=causal)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    return launch(q, k, v, out, causal=causal, block_q=block_q,
                  block_k=block_k)


flash_attention.launches = 0
flash_attention.variant_launches = {"mma": 0, "fma": 0}


def _heads(t, bthd):
    """A (B, T, heads, hd) tensor as the (B, heads, T, hd) view K4 takes
    (``bthd``), or the tensor itself."""
    return t.transpose(1, 2) if bthd else t


def _stream(device) -> int:
    """The current stream's cudaStream_t on ``device``."""
    with torch.cuda.device(device):
        return torch.cuda.current_stream().cuda_stream


def backward_kernel(variant, dtype):
    """The C entry point of the backward kernel ``variant`` (``"mma"``:
    bf16 only; ``"fma"``) for ``dtype``; builds its library at first
    use."""
    if variant == "mma":
        return LIBRARY_BWD_MMA.lib().k4_flash_attention_bwd_bf16_mma
    return getattr(LIBRARY_BWD.lib(),
                   f"k4_flash_attention_bwd_{_SUFFIX[dtype]}")


def run_backward(fn, q, k, v, dout, lse, dq, dk, dv, *, causal):
    """Launch the backward entry point ``fn`` (``backward_kernel``) on the
    current stream for inputs ``launch_backward`` has checked, without
    counting it; raises if the launch fails."""
    B, H, Tq, hd = q.shape
    KV, Tk = k.shape[1], k.shape[2]
    delta = torch.empty((B, H, Tq), dtype=torch.float32, device=q.device)
    strides = _BWD_STRIDES(*(s for t in (q, k, v, dout, dq, dk, dv)
                             for s in t.stride()[:3]))
    rc = fn(*(t.data_ptr() for t in (q, k, v, dout, lse, delta, dq, dk, dv)),
            B, H, KV, Tq, Tk, hd, strides, int(bool(causal)), hd ** -0.5,
            _stream(q.device))
    if rc != 0:
        raise RuntimeError(f"flash_attention backward launch failed: "
                           f"cudaError {rc} at q {tuple(q.shape)}, k "
                           f"{tuple(k.shape)}")


def launch_backward(q, k, v, dout, lse, dq, dk, dv, *, causal):
    """K4's backward on the current stream: the gradients of
    ``flash_attention(q, k, v)`` for the output gradient ``dout``, given
    the forward's row logsumexp ``lse``, written into ``dq``, ``dk``,
    ``dv`` (the inputs' shapes and dtype, any strides with a contiguous
    head dim) by the kernel ``kernel_variant`` picks; counts one launch
    (its two or three kernels)."""
    B, H, KV, Tq, Tk, hd = check_inputs(q, k, v, 1, 1)
    ts = (dout, dq, dk, dv)
    like = (q, q, k, v)
    if any(t.shape != r.shape or t.dtype != q.dtype or t.stride(-1) != 1
           or t.device != q.device for t, r in zip(ts, like)):
        raise ValueError("flash_attention_backward: dout, dq, dk, dv do not "
                         "match q, k, v")
    if lse.shape != (B, H, Tq) or lse.dtype != torch.float32 \
            or not lse.is_contiguous():
        raise ValueError("flash_attention_backward: lse must be a "
                         f"contiguous f32 ({B}, {H}, {Tq}) tensor")
    if B * H * Tq == 0 or Tk == 0:
        for t in (dq, dk, dv):
            t.zero_()
        return
    variant = kernel_variant(q, k, v, *ts)
    run_backward(backward_kernel(variant, q.dtype), q, k, v, dout, lse, dq,
                 dk, dv, causal=causal)
    flash_attention_backward.launches += 1
    flash_attention_backward.variant_launches[variant] += 1


def flash_attention_backward(q, k, v, dout, lse, *, causal, bthd=False):
    """The gradients (dq, dk, dv) of ``K4(q, k, v)`` for the output
    gradient ``dout``, given the forward's f32 row logsumexp ``lse``
    (B, H, Tq); in the inputs' layout ((B, H, T, hd), or (B, T, H, hd) with
    ``bthd``) and dtype. CPU tensors take ``flash_attention_bwd_ref``; CUDA
    tensors launch the backward kernel ``kernel_variant`` picks (or raise).
    Launch count: ``flash_attention_backward.launches``, and per kernel
    ``flash_attention_backward.variant_launches``."""
    if dout.stride(-1) != 1:
        dout = dout.contiguous()
    views = [_heads(t, bthd) for t in (q, k, v, dout)]
    if counting.active() is not None:
        shape = check_inputs(*views[:3], 1, 1)
        B, H, _, Tq, Tk, _ = shape
        delta = (((B, H, Tq), torch.float32),) if B * H * Tq and Tk else ()
        return tuple(count_unit(
            "K4bwd", counting.flash_bwd_work(shape, causal,
                                             q.element_size()),
            q, [(t.shape, t.dtype) for t in (q, k, v)],
            lambda: _backward(q, k, v, dout, lse, views, causal, bthd),
            delta))
    return _backward(q, k, v, dout, lse, views, causal, bthd)


def _backward(q, k, v, dout, lse, views, causal, bthd):
    if on_cpu("flash_attention_backward", q, k, v, dout, lse):
        grads = flash_attention_bwd_ref(*views, lse, causal=causal)
        return tuple(_heads(g, bthd) for g in grads)
    dq, dk, dv = (torch.empty(t.shape, dtype=t.dtype, device=t.device)
                  for t in (q, k, v))
    launch_backward(*views, lse, *(_heads(t, bthd) for t in (dq, dk, dv)),
                    causal=causal)
    return dq, dk, dv


flash_attention_backward.launches = 0
flash_attention_backward.variant_launches = {"mma": 0, "fma": 0}


class FlashAttention(torch.autograd.Function):
    """K4 with its gradient. ``apply(q, k, v, causal, block_q, block_k,
    bthd)``: q, k, v in K4's (B, heads, T, hd) layout, or in the model's
    (B, T, heads, hd) with ``bthd``; the output in the same layout. The
    forward saves q, k, v and the f32 row logsumexp; the backward is
    ``flash_attention_backward``."""

    @staticmethod
    def forward(ctx, q, k, v, causal, block_q, block_k, bthd):
        if counting.active() is not None:
            shape = check_inputs(*(_heads(t, bthd) for t in (q, k, v)),
                                 block_q, block_k)
            B, H, _, Tq, _, _ = shape
            out, lse = count_unit(
                "K4", counting.flash_work(shape, causal, q.element_size(),
                                          lse=True),
                q, ((q.shape, q.dtype), ((B, H, Tq), torch.float32)),
                lambda: FlashAttention.run(q, k, v, causal, block_q,
                                           block_k, bthd))
        else:
            out, lse = FlashAttention.run(q, k, v, causal, block_q, block_k,
                                          bthd)
        ctx.save_for_backward(q, k, v, lse)
        ctx.causal, ctx.bthd = causal, bthd
        return out

    @staticmethod
    def run(q, k, v, causal, block_q, block_k, bthd):
        """The forward's (out, lse): the plain version on the CPU, the
        kernel on the card."""
        qh, kh, vh = (_heads(t, bthd) for t in (q, k, v))
        cpu = on_cpu("flash_attention", q, k, v)
        B, H, _, Tq, _, _ = check_inputs(qh, kh, vh, block_q, block_k)
        if cpu:
            oh, lse = flash_attention_ref(qh, kh, vh, causal=causal,
                                          return_lse=True)
            out = _heads(oh, bthd)
        else:
            out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
            lse = torch.empty((B, H, Tq), dtype=torch.float32,
                              device=q.device)
            launch(qh, kh, vh, _heads(out, bthd), causal=causal,
                   block_q=block_q, block_k=block_k, lse=lse)
        return out, lse

    @staticmethod
    def backward(ctx, dout):
        q, k, v, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_backward(q, k, v, dout, lse,
                                              causal=ctx.causal,
                                              bthd=ctx.bthd)
        return dq, dk, dv, None, None, None, None
