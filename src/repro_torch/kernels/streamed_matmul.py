"""K1, K2, K3 — the streamed matmuls — and the host-side quantisers.

``streamed_matmul(x, w)`` computes ``(M, K) @ (K, N)`` with both operands
upcast to f32, an f32 sum over K and the result in ``x.dtype`` — what the
reference's Pallas ``streamed_matmul`` computes. ``streamed_matmul_int8``
and ``streamed_matmul_int4`` compute the same product with the weight
stored as grouped int8 codes (``quantize_int8``) or packed int4 codes
(``quantize_int4``), dequantised inside the kernel. On a CUDA tensor each
wrapper launches its hand-written Hopper kernel on the current stream (or
raises); on a CPU tensor it computes the plain version in
``kernels/ref.py``. There is no fallback from one to the other. In bf16
all three run on the tensor cores (``csrc/streamed_matmul_mma.cu``:
mma.sync, a cp.async ring and a split of K fixed by (K, N), see
``split_plan``; K2 and K3 convert their codes in registers to exact bf16
fragments and scale each group's f32 partial sum); in f32 they run the
f32 tile kernel of ``csrc/streamed_matmul.cu`` (``kernel_variant``). Both
keep every row's result independent of M, bit for bit.

Unlike the Pallas kernels, the CUDA kernels mask ragged tiles and take
ragged quantisation groups, so any (M, K, N) and any group count are
accepted: the dense FFN of qwen2-0.5b (d=896, f=4864) and the smoke widths
(d=56, f=112) both run through them.

Gradients. When autograd needs one (grad mode on and x or w requiring
grad), ``streamed_matmul`` runs through ``StreamedMatmul``, a
``torch.autograd.Function``: the forward is the same kernel (one launch),
the backward is dx = dy @ w^T and dw = x^T @ dy by ``torch.matmul`` in the
operands' dtype with f32 sums. The JAX package differentiates its MoE
experts' and router's products by autodiff of jnp einsums outside any
Pallas kernel, so those two products are plain library calls here too.
K2 and K3 take no gradient: their weights are integer codes, which the
reference cannot differentiate either, and a call that autograd would
need to differentiate raises.

Counting. Inside ``launch/counting.py``'s ``count_step`` each call is one
unit counted by hand (``_counted``): 2MKN operations and x, the stored
weight and y moved once, the bf16 kernel's split-K workspace and tile
counters as temporaries, and an empty (M, N) output on fake tensors (the
plain version on the CPU and the kernel on the card otherwise, as
outside a count). Outside a count a fake tensor raises (``on_cpu``).

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
import functools
from pathlib import Path

import torch

from repro_torch.device import is_fake, needs_grad, on_cpu
from repro_torch.kernels._build import CudaLibrary
from repro_torch.kernels.ref import (streamed_matmul_int4_ref,
                                     streamed_matmul_int8_ref,
                                     streamed_matmul_ref)
from repro_torch.launch import counting

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
# the weight's pointers, then out workspace counters M N K [g] k_split stream
_MMA_TAIL = [_P, _P, _P, _I, _I, _I]
_CSRC = Path(__file__).resolve().parent / "csrc"
LIBRARY = CudaLibrary(
    _CSRC / "streamed_matmul.cu",
    {"k1_streamed_matmul_f32": _K1_ARGS,
     "k2_streamed_matmul_int8_f32": _K2_ARGS,
     "k3_streamed_matmul_int4_f32": _K3_ARGS})
LIBRARY_MMA = CudaLibrary(
    _CSRC / "streamed_matmul_mma.cu",
    {"k1_streamed_matmul_bf16": [_P, _P] + _MMA_TAIL + [_I, _P],
     "k2_streamed_matmul_int8_bf16_mma": [_P] * 3 + _MMA_TAIL + [_I, _I, _P],
     "k3_streamed_matmul_int4_bf16_mma": [_P] * 4 + _MMA_TAIL
     + [_I, _I, _P]})
_DTYPES = (torch.bfloat16, torch.float32)
_INT_MAX = 2 ** 31 - 1

# K1, K2, K3 in bf16 (csrc/streamed_matmul_mma.cu): 64-column output tiles,
# and a split of K, in units of 64 rows, fixed by (K, N) alone.
MMA_BN = 64
MMA_BK = 64
TARGET_BLOCKS = 264          # two waves of the H100's 132 SMs
MIN_SPLIT_KTILES = 2         # no split shorter than 128 rows of K
ROW_SLICE = 256              # rows per launch: bounds the workspace
WORKSPACE_MAX = 24 * 2 ** 20  # f32 partials of one row slice, at most


@functools.lru_cache(maxsize=256)
def split_plan(K: int, N: int):
    """(S, k_split): the bf16 kernels' split of the K axis into S ranges
    of ``k_split`` rows (a multiple of ``MMA_BK``; the last range ragged).
    A function of (K, N) only, never of M, so every row of any M sums the
    same k16 steps in the same ranges and order. It aims at
    ``TARGET_BLOCKS`` blocks for one tile row (ceil(N / 64) column tiles
    times S), keeps each split at least ``MIN_SPLIT_KTILES`` k-tiles deep,
    and keeps a row slice's f32 partials within ``WORKSPACE_MAX``."""
    nkt = -(-K // MMA_BK)
    ntiles = -(-N // MMA_BN)
    want = -(-TARGET_BLOCKS // max(ntiles, 1))
    cap_ws = WORKSPACE_MAX // (ROW_SLICE * max(N, 1) * 4)
    S = max(1, min(want, nkt // MIN_SPLIT_KTILES, cap_ws))
    kts = max(1, -(-nkt // S))
    return max(1, -(-nkt // kts)), kts * MMA_BK


def row_slices(M: int):
    """The row ranges the bf16 kernels launch over: ``ROW_SLICE`` rows
    each, the last ragged. Exact, because their rows do not depend on M."""
    return [(r, min(r + ROW_SLICE, M)) for r in range(0, M, ROW_SLICE)]


def workspace_shape(M: int, K: int, N: int):
    """The f32 partials a bf16 kernel allocates for an (M, K) @ (K, N) call:
    (S, rows of one slice, N), or None without a split."""
    S, _ = split_plan(K, N)
    return None if S == 1 else (S, min(M, ROW_SLICE), N)


def _tile_counters(device, stream, n):
    """The bf16 kernels' per-output-tile arrival counters for launches on
    ``stream`` of ``device``. The kernel leaves them zeroed, so they are
    allocated (and zeroed) once and grown when a launch needs more. A
    tile's last block is found by its counter, so two launches that may
    run at the same time must not share one: launches on one stream run
    in order, those on two streams may overlap, hence one buffer per
    (device, stream). A grown buffer replaces the old one, whose block the
    caching allocator hands out again only in the order of the stream it
    was made on, this one."""
    key = (device.index, stream)
    buf = _COUNTERS.get(key)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 4096), dtype=torch.int32, device=device)
        _COUNTERS[key] = buf
    return buf


_COUNTERS = {}


def _raw_stream(device) -> int:
    """The current stream's cudaStream_t on ``device``. PyTorch's CUDA
    builds bind it directly (``_cuda_getCurrentRawStream``: 0.1 us a call
    on the H100 machine's host, against 6-9 us for
    ``torch.cuda.current_stream(device).cuda_stream``, which builds a
    Stream object); the public call is the way where the binding is
    missing."""
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if raw is not None:
        return raw(device.index)
    return torch.cuda.current_stream(device).cuda_stream


def _check(name, x, w, K_w, N):
    """Shared checks of x against a (K_w, N) weight; returns (M, K, N)."""
    if x.dtype not in _DTYPES:
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
    """An f32 kernel of ``LIBRARY``: allocate the output and launch
    ``fn_name`` on the current stream."""
    dev = x.device
    if dev.index != torch.cuda.current_device():
        with torch.cuda.device(dev):
            return _launch(name, fn_name, x, ptrs, M, N, K, extra)
    out = torch.empty((M, N), dtype=x.dtype, device=dev)
    if M == 0 or N == 0:
        return out, False
    fn = getattr(LIBRARY.lib(), fn_name)
    rc = fn(x.data_ptr(), *(t.data_ptr() for t in ptrs), out.data_ptr(), M,
            N, K, *extra, _raw_stream(dev))
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {rc} "
                           f"at M={M} K={K} N={N}")
    return out, True


def streamed_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """K1. x: (M, K) activations; w: (K, N) weights of x's dtype. Returns
    (M, N) in ``x.dtype``. Launch count: ``streamed_matmul.launches`` (one
    per call), and per kernel ``streamed_matmul.variant_launches``. Under
    autograd it runs through ``StreamedMatmul`` (the same launch)."""
    if needs_grad(x, w):
        return StreamedMatmul.apply(x, w)
    return _streamed_matmul(x, w)


class StreamedMatmul(torch.autograd.Function):
    """K1 with its gradient: the forward is K1, the backward dx = dy @ w^T
    and dw = x^T @ dy through ``torch.matmul`` (operands' dtype, f32
    sums)."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return _streamed_matmul(x, w)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dx = dy @ w.T if ctx.needs_input_grad[0] else None
        dw = x.T @ dy if ctx.needs_input_grad[1] else None
        return dx, dw


def _no_grad_only(name, x):
    """K2 and K3 take no gradient (integer weights)."""
    if needs_grad(x):
        raise RuntimeError(f"{name} takes no gradient: quantised weights "
                           "are not trained (K2 and K3 have no backward)")


def _counted(name, unit, x, weights, K_w, run):
    """A K1, K2 or K3 call inside a count (``launch/counting.py``): the
    hand count of (M, K) @ (K, N) with the stored weight ``weights``
    (codes, scales, zeros) read once; the bf16 kernel's f32 split-K
    workspace and per-tile counters as temporaries where ``split_plan``
    splits K; and the output: an empty (M, N) on fake tensors, else
    ``run()`` (the plain version on the CPU, the kernel on the card)."""
    M, K, N = _check(name, x, weights[0], K_w, weights[0].shape[-1])
    work = counting.matmul_work(M, K, N, x.element_size(),
                                w_bytes=sum(map(counting.nbytes, weights)))
    shape = workspace_shape(M, K, N) if x.dtype == torch.bfloat16 \
        and M and N else None
    temps = () if shape is None else (
        (shape, torch.float32),
        ((-(-shape[1] // 16) * -(-N // MMA_BN),), torch.int32))
    with counting.active().unit(unit, work, temps, x.device) as done:
        return done(torch.empty((M, N), dtype=x.dtype, device=x.device)
                    if is_fake(x) else run())


def _streamed_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """K1's launch (or its plain version on the CPU), counted."""
    if counting.active() is not None:
        return _counted("streamed_matmul", "K1", x, (w,), w.shape[0],
                        lambda: _k1(x, w))
    return _k1(x, w)


def _k1(x, w):
    if on_cpu("streamed_matmul", x, w):
        return streamed_matmul_ref(x, w)
    if w.dtype != x.dtype:
        raise ValueError(f"streamed_matmul takes bf16 or f32 of one dtype, "
                         f"got x {x.dtype}, w {w.dtype}")
    M, K, N = _check("streamed_matmul", x, w, w.shape[0], w.shape[-1])
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("streamed_matmul takes contiguous row-major x, w")
    if x.dtype == torch.bfloat16:
        out, launched = _launch_mma("streamed_matmul",
                                    "k1_streamed_matmul_bf16", x, (w,), M,
                                    K, N)
    else:
        out, launched = _launch("streamed_matmul", "k1_streamed_matmul_f32",
                                x, (w,), M, N, K)
    streamed_matmul.launches += launched
    streamed_matmul.variant_launches[kernel_variant(x.dtype)] += launched
    return out


def kernel_variant(dtype) -> str:
    """Which kernel K1, K2 and K3 take for activations of ``dtype``:
    ``"mma"`` (bf16, tensor cores, ``csrc/streamed_matmul_mma.cu``) or
    ``"fma"`` (f32, the f32 tile kernel of ``csrc/streamed_matmul.cu``).
    Every group size takes the same kernel."""
    return "mma" if dtype == torch.bfloat16 else "fma"


def _launch_mma(name, fn_name, x, weights, M, K, N, extra=()):
    """A bf16 kernel of ``LIBRARY_MMA`` for x @ the tensors ``weights``
    (``extra``: the ints between K and k_split): one launch per row slice
    on the current stream, f32 partials in a workspace when ``split_plan``
    splits K. Decode calls it 72 times a step on a host-bound path, so it
    stays lean: one device lookup, no tensor per slice."""
    dev = x.device
    if dev.index != torch.cuda.current_device():
        with torch.cuda.device(dev):
            return _launch_mma(name, fn_name, x, weights, M, K, N, extra)
    out = torch.empty((M, N), dtype=torch.bfloat16, device=dev)
    if M == 0 or N == 0:
        return out, False
    _, k_split = split_plan(K, N)
    stream = _raw_stream(dev)
    shape = workspace_shape(M, K, N)
    ws = ws_ptr = counters_ptr = None
    # ws is freed on return, after the launches are queued: the caching
    # allocator hands its block out again only in this stream's order
    if shape is not None:
        ws = torch.empty(shape, dtype=torch.float32, device=dev)
        ws_ptr = ws.data_ptr()
        # one counter per output tile; tiles hold at least 16 rows
        counters_ptr = _tile_counters(
            dev, stream, -(-shape[1] // 16) * -(-N // MMA_BN)).data_ptr()
    fn = getattr(LIBRARY_MMA.lib(), fn_name)
    w_ptrs = [t.data_ptr() for t in weights]
    x_ptr, o_ptr = x.data_ptr(), out.data_ptr()
    for r0, r1 in row_slices(M):
        rc = fn(x_ptr + 2 * r0 * K, *w_ptrs, o_ptr + 2 * r0 * N, ws_ptr,
                counters_ptr, r1 - r0, N, K, *extra, k_split, stream)
        if rc != 0:
            raise RuntimeError(f"{name} kernel launch failed: cudaError "
                               f"{rc} at M={r1 - r0} K={K} N={N}")
    return out, True


def streamed_matmul_int8(x: torch.Tensor, w_q: torch.Tensor,
                         scales: torch.Tensor) -> torch.Tensor:
    """K2. x: (M, K) bf16 or f32; w_q: (K, N) int8 codes; scales: (G, 1, N)
    f32 (``quantize_int8``). Returns ``x.f32 @ dequant_int8(w_q, scales)``
    in ``x.dtype``. Launch count: ``streamed_matmul_int8.launches``, and
    per kernel ``streamed_matmul_int8.variant_launches``."""
    name = "streamed_matmul_int8"
    _no_grad_only(name, x)
    if counting.active() is not None:
        return _counted(name, "K2", x, (w_q, scales), w_q.shape[0],
                        lambda: _k2(x, w_q, scales))
    return _k2(x, w_q, scales)


def _k2(x, w_q, scales):
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
    if x.dtype == torch.bfloat16:
        out, launched = _launch_mma(name, "k2_streamed_matmul_int8_bf16_mma",
                                    x, (w_q, scales), M, K, N, extra=(g,))
    else:
        out, launched = _launch(name, "k2_streamed_matmul_int8_f32", x,
                                (w_q, scales), M, N, K, extra=(g,))
    streamed_matmul_int8.launches += launched
    streamed_matmul_int8.variant_launches[kernel_variant(x.dtype)] += \
        launched
    return out


def streamed_matmul_int4(x: torch.Tensor, w_packed: torch.Tensor,
                         scales: torch.Tensor,
                         zeros: torch.Tensor) -> torch.Tensor:
    """K3. x: (M, K) bf16 or f32; w_packed: (K//2, N) uint8, two int4 codes
    per byte (low nibble = even K row); scales: (G, N) fp16; zeros: (G, N)
    uint8 (``quantize_int4``). Returns ``x.f32 @ dequant_int4(...)`` in
    ``x.dtype``; any group count, ragged or odd groups included. Launch
    count: ``streamed_matmul_int4.launches``, and per kernel
    ``streamed_matmul_int4.variant_launches``."""
    name = "streamed_matmul_int4"
    _no_grad_only(name, x)
    if counting.active() is not None:
        return _counted(name, "K3", x, (w_packed, scales, zeros),
                        2 * w_packed.shape[0],
                        lambda: _k3(x, w_packed, scales, zeros))
    return _k3(x, w_packed, scales, zeros)


def _k3(x, w_packed, scales, zeros):
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
    if x.dtype == torch.bfloat16:
        out, launched = _launch_mma(name, "k3_streamed_matmul_int4_bf16_mma",
                                    x, (w_packed, scales, zeros), M, K, N,
                                    extra=(g,))
    else:
        out, launched = _launch(name, "k3_streamed_matmul_int4_f32", x,
                                (w_packed, scales, zeros), M, N, K,
                                extra=(g,))
    streamed_matmul_int4.launches += launched
    streamed_matmul_int4.variant_launches[kernel_variant(x.dtype)] += \
        launched
    return out


streamed_matmul.launches = 0
streamed_matmul.variant_launches = {"mma": 0, "fma": 0}
streamed_matmul_int8.launches = 0
streamed_matmul_int8.variant_launches = {"mma": 0, "fma": 0}
streamed_matmul_int4.launches = 0
streamed_matmul_int4.variant_launches = {"mma": 0, "fma": 0}
