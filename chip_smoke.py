#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases (each raises on failure; the last line is printed only if all pass):

1. environment: the card's name and power limit, torch and CUDA versions;
   builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc``,
   one nvcc per source, all started together: K1, K2, K3 in f32
   (``streamed_matmul.cu``); K1, K2, K3 in bf16 on the tensor cores
   (``streamed_matmul_mma.cu``); K4 on the CUDA cores (f32, and bf16 at
   shapes the tensor-core kernel does not take: ``flash_attention.cu``);
   K4 in bf16 on the tensor cores (``flash_attention_mma.cu``);
2. kernels: K1 (streamed_matmul) against its plain PyTorch version at the
   main path's shapes and at ragged shapes, bf16 and f32, each dtype on
   its own kernel (per-variant launch counts); row independence bit for
   bit, also over slices that cross M = 16 and the wrapper's 256-row
   slicing; split-K on two streams at once equal to one stream; times of
   the kernel (CUDA events over back-to-back calls, and
   the kernel's own device time from ``torch.profiler``), the plain
   version and ``torch.matmul`` (the yardstick only — the port never
   calls it); K1 also at qwen30b-a3b's expert shapes (bf16, timed) and
   router shapes (f32). Then
   K2 (streamed_matmul_int8) and K3 (streamed_matmul_int4) on weights
   quantised on the card by the port's quantisers, at the main path's
   shapes, at qwen3-14b's FFN widths, and at ragged and odd quantisation
   groups (g of 117, 125, 63, 5, 3, 1) and at qwen30b-a3b's expert shapes
   (K2 also as one group, the ``expert_quant`` form, with its row
   independence), bf16 on the tensor-core kernel and
   f32 on the CUDA-core one (per-variant launch counts); bf16 also within a
   limit set by the kernel's rounding (the bf16 output and its f32 sums)
   against the plain version before its cast, which the kernel fed x with
   one group's rows zeroed (a planted fault, at a main-path shape and at a
   ragged group whose boundaries cut k16 steps) must exceed 5 times; row
   independence bit for bit over slices of 256 and 600 rows, across
   M = 16 and the 256-row slicing, ragged groups too; split-K on two
   streams at once equal to one stream; their times (events and device
   time), their plain versions' times and, as context only,
   ``torch.matmul`` on the dequantised bf16 weight (not the same function:
   no single PyTorch call computes these, so their ``library_ms`` is
   null). Then K4
   (flash_attention) against its plain version over the sweep of
   tests/test_kernels.py, at the VLM path's vision (720p encoder) and
   language (qwen2-vl-7b at 4096 tokens) shapes, a ragged causal length
   and Tq != Tk, bf16 and f32 (the vision and language shapes in f32 as
   well), bf16 on the tensor-core kernel and f32 on the CUDA-core one
   (per-variant launch counts); bf16 also within a limit set by the
   tensor-core kernel's rounding of p and of its output, which the
   kernel run without its last kv tile (a planted fault, at the vision,
   language and ragged shapes) must exceed; its results across
   ``block_q`` (64, 128 and the reference's 663) at the vision shape in
   f32 and in bf16; its
   times (events and device time), the plain version's and
   ``scaled_dot_product_attention``'s (the yardstick only);
3. main path: full-width, full-depth qwen2-0.5b with seeded random bf16
   weights, served through ``Session.open`` -> ``serve`` at VRAM budgets of
   2.0x, 0.5x and 0.1x of the model's weight bytes on the measured link:
   identical tokens across budgets, the streamed-bytes ledger, K1's launch
   count (all on the tensor-core kernel), peak device memory within a
   computed bound, and the served
   tokens checked against the monolithic forward under teacher forcing;
4. live re-budget: 2.0x -> 0.1x mid-serve, tokens equal the uninterrupted
   run, moved bytes equal ``Schedule.diff``;
5. the baselines at 0.1x: overlap against sync, per-slot against fused
   decode, chunk-major against layer-major prefill, each with identical
   tokens;
6. where the decode time goes at 0.1x: ``torch.profiler`` over a few
   fused decode steps, device time by kernel and the device's busy share
   of the window (launches here are outside the counted main-path run);
7. the quantised main paths: the same weights with every FFN quantised by
   the port (``weight_quant`` int8, then int4), served at 2.0x, 0.25x and
   0.1x of that mode's own weight bytes: identical tokens across budgets,
   the streamed-bytes ledger per dtype, K2's or K3's launch count equal to
   three per FFN call, all on the tensor-core kernel, and no K1 launch, no
   ``_dequant`` call, peak memory
   within the bound, the teacher-forced check; at 0.1x in int4 also
   overlap == sync and per-slot == fused; a profile of int4 decode;
8. the VLM path, vision: the VLMOpt encoder at full width (d=1280, 32
   layers, 16 heads, seeded bf16 weights drawn on the card) encodes 720p
   (4641 patches) through K4: one K4 launch per layer and Q-chunk of 1024
   rows (160 per encode), all on the tensor-core kernel (the f32 encode:
   all on the CUDA-core one); peak memory of the flash and the plain
   encode against the N^2 score bytes, and gated at or under the
   analytic ``vision_vram_demand`` (720p flash and plain, 1440p flash);
   bf16 flash against plain (a coarse gate) and each layer's K4 launch
   within the bf16-p limit on its own q, k, v, which a planted fault
   must exceed; flash == plain with f32 weights; K4's share of one encode's kernel time
   (``torch.profiler``); 1440p (18564 patches) through K4;
9. the VLM path, language: qwen2-vl-7b at its published widths and depth
   (seeded bf16 weights drawn on the card), 1024 vision embeddings and
   3072 text tokens with 3D positions: the no-cache forward at 4096 tokens
   through K4 (28 launches, tensor cores) against the cached prefill's
   logits, peak memory below the plain attention's, K4's share of its
   kernel time, each layer's K4 within the bf16-p limit; ``Model.prefill`` and 16 greedy
   ``decode_step``s checked under teacher forcing against a no-cache
   forward;
10. planning: a planning-only ``Session`` of qwen2-vl-7b on the h100 at 4
   and 8 GB;
11. MoE: qwen30b-a3b at its published widths (d=2048, 32/4 heads, hd=128,
   128 experts top-8, d_expert=768, vocab 151936) and 12 of its 48 layers,
   seeded bf16 weights drawn on the card one matrix at a time, served as
   phase 3 serves (4 requests of 64 + 16 tokens, ``max_batch=4``): expert-
   granular at 2.0x, 0.5x and 0.1x of the graph's weight bytes, monolithic
   at 2.0x and 0.5x, granular without overlap at 0.1x: identical tokens
   across all six, the ledger (streamed == static plan + demanded expert
   bytes, per dtype), overlap and sync streaming equal bytes, each decode
   step's demanded experts per layer <= active tokens x top_k, peak
   memory within the bound (which counts the (E, C, d) dispatch and
   output buffers), K1's launches: 3 per expert call on the tensor cores
   and one f32 router call each on the CUDA cores; the served tokens
   under teacher forcing against a plain monolithic forward (router by
   ``torch.matmul`` in f32, each expert dequantised and multiplied by
   ``torch.matmul``: no kernel launches in it); each run's demand slots;
   a profile of granular decode at 0.1x. Then per-expert int8
   (``expert_quant``, K2 as one group) and int4 (``weight_quant``, K3)
   experts, each granular and monolithic at 0.5x and granular at 0.1x
   with identical tokens, 3 K2 or K3 launches per expert call, no
   ``_dequant``, and the same plain teacher-forced check.

It needs one CUDA card and exits non-zero without one, or when run from a
directory that does not hold the repository's ``src/repro_torch``.
"""
from __future__ import annotations

import gc
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# H100 SXM data sheet: dense bf16 tensor
# rate, f32 rate outside the tensor cores, HBM3 bandwidth.
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_HBM_BPS = 3.35e12
L2_BYTES = 50 * 2 ** 20
TOL = {"bfloat16": dict(rtol=2e-2, atol=2e-2),   # bf16 output rounding
       "float32": dict(rtol=1e-4, atol=5e-4)}    # f32 sum order only
BUDGETS = (2.0, 0.5, 0.1)
QUANT_BUDGETS = (2.0, 0.25, 0.1)
QUANT_MODES = ("int8", "int4")
# served tokens against the monolithic forward: each must be its
# position's argmax up to this logit gap (bf16 near-ties; the monolithic
# FFN runs through torch.matmul on bf16 (dequantised) weights, the served
# one through K1 / K2 / K3 in f32)
TF_GAP = 0.25
N_REQ, PROMPT_LEN, NEW_TOKENS, MAX_BATCH, MAX_SEQ = 4, 64, 16, 4, 256
ACT_ALLOWANCE = 64 * 2 ** 20


def log(*a):
    print(*a, flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


# ------------------------------------------------------------ phase 1
def build_kernels():
    """One nvcc per source, all started together."""
    from concurrent.futures import ThreadPoolExecutor
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import streamed_matmul as sm
    libs = {"K1, K2, K3 f32": sm.LIBRARY,
            "K1, K2, K3 bf16 (mma)": sm.LIBRARY_MMA,
            "K4 (fma)": fa.LIBRARY, "K4 bf16 (mma)": fa.LIBRARY_MMA}
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(libs)) as pool:
        list(pool.map(lambda lib: lib.lib(), libs.values()))
    for name, lib in libs.items():
        log(f"built {name} ({', '.join(lib.symbols)}): "
            f"{lib.library_path().name} (nvcc "
            f"{lib.build_s if lib.build_s is not None else 0.0:.2f} s)")
        for line in lib.build_log.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                log(f"  ptxas: {line.strip()}")
    log(f"kernel build wall time: {time.perf_counter() - t0:.2f} s")


# ------------------------------------------------------------ phase 2
def time_ms(fn, args_list, iters=None):
    """Mean ms per call over cycling argument sets, by CUDA events, after
    a warm-up. The argument sets together exceed the L2 cache, so each call
    reads its weight cold as the served model does."""
    import torch
    iters = iters or max(20, 2 * len(args_list))
    for a in args_list[:3]:
        fn(*a)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(*args_list[i % len(args_list)])
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


# kernel names as torch.profiler reports them (each an anonymous-namespace
# template): K1, K2 and K3 in bf16 on the tensor cores (one template over
# the weight format: mm_mma_kernel<DenseB | Int8B | Int4B, ...>); the f32
# tile kernel that runs K1, K2 and K3 in f32; K4 on the tensor cores and on
# the CUDA cores
MM_MMA, MM_FMA = "::mm_mma_kernel<", "::mm_kernel<"
FLASH_MMA, FLASH_FMA = "::flash_mma_kernel<", "::flash_kernel<"


def profiled(fn, host=False):
    """Run ``fn`` once under ``torch.profiler`` and synchronise; returns
    (``key_averages()``, wall us of the window). ``host`` records the
    host's ops as well as the device's."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if host
                                      else [])
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    return prof.key_averages(), wall_us


def kernel_us(events, names=None):
    """Device us of the kernels in ``events`` (memory copies left out)
    whose name holds one of ``names``; every kernel's when None."""
    import torch
    return sum(e.self_device_time_total for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.key.lower().startswith("memcpy")
               and (names is None or any(n in e.key for n in names)))


def device_ms(fn, args_list, names, iters=None):
    """The kernel's own device time per call, in ms: ``torch.profiler``
    over the same cycling calls as ``time_ms``, summing the device time of
    the kernels named by ``names``. Unlike ``time_ms`` it leaves out the
    host's time between launches. None when the profiler saw no such
    kernel (not measured)."""
    import torch
    iters = iters or max(20, 2 * len(args_list))
    for a in args_list[:3]:
        fn(*a)
    torch.cuda.synchronize()

    def calls():
        for i in range(iters):
            fn(*args_list[i % len(args_list)])
    us = kernel_us(profiled(calls)[0], names)
    return us / iters / 1e3 if us > 0 else None


def bound(M, K, N, dtype_bytes, flops_peak, w_bytes=None):
    """Least ms for (M,K)@(K,N): each input byte read once and the output
    written once over the HBM rate, or 2MNK over ``flops_peak``. ``w_bytes``
    replaces the weight's K*N*dtype_bytes (quantised codes, scales and
    zeros)."""
    if w_bytes is None:
        w_bytes = K * N * dtype_bytes
    byts = (M * K + M * N) * dtype_bytes + w_bytes
    t_bytes = byts / PEAK_HBM_BPS * 1e3
    t_ops = 2.0 * M * N * K / flops_peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def fmt_ms(ms):
    return "not measured" if ms is None else f"{ms:.4f} ms"


def check_close(name, out, ref, dtype):
    import torch
    tol = TOL[dtype]
    err = (out.float() - ref.float()).abs()
    lim = tol["atol"] + tol["rtol"] * ref.float().abs()
    if not bool(torch.isfinite(out).all()):
        raise AssertionError(f"{name}: non-finite kernel output")
    if bool((err > lim).any()):
        raise AssertionError(f"{name}: max |err| {err.max().item():.3e} "
                             f"beyond rtol={tol['rtol']} atol={tol['atol']}")
    return err.max().item()


def kernel_phase():
    import torch
    from repro_torch.kernels import ref as kref
    from repro_torch.kernels import streamed_matmul as sm
    from repro_torch.kernels.streamed_matmul import streamed_matmul
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1234)
    before = streamed_matmul.launches
    reset_variants()
    max_err = 0.0
    shapes = []
    # ragged smoke shapes, bf16 and f32 (qwen2-0.5b smoke: d=56, f=112)
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).split(".")[-1]
        for (M, K, N) in ((1, 56, 112), (4, 112, 56), (3, 37, 129),
                          (17, 56, 112), (65, 112, 56), (130, 300, 70)):
            x = torch.randn((M, K), generator=gen, device=dev).to(dtype)
            w = (torch.randn((K, N), generator=gen, device=dev)
                 / K ** 0.5).to(dtype)
            e = check_close(f"K1 {dname} ({M},{K})@({K},{N})",
                            streamed_matmul(x, w),
                            kref.streamed_matmul_ref(x, w), dname)
            max_err = max(max_err, e)
    log(f"K1 ragged shapes within tolerance (max |err| {max_err:.3e})")
    want = {"mma": 6, "fma": 6}         # bf16 on the tensor cores, f32 not
    if streamed_matmul.variant_launches != want:
        raise AssertionError(f"K1 ragged shapes took "
                             f"{streamed_matmul.variant_launches} != {want}")
    log(f"K1 ragged shapes by kernel: {streamed_matmul.variant_launches}")
    # the MoE router's logits: f32, (T, 2048) @ (2048, 128), on the f32
    # kernel at decode and prefill row counts
    for M in (4, 64):
        x = torch.randn((M, 2048), generator=gen, device=dev)
        w = torch.randn((2048, 128), generator=gen, device=dev) / 2048 ** 0.5
        max_err = max(max_err, check_close(
            f"K1 float32 ({M},2048)@(2048,128)", streamed_matmul(x, w),
            kref.streamed_matmul_ref(x, w), "float32"))
    # the main path's shapes (qwen2-0.5b's FFN, then qwen30b-a3b's
    # experts), bf16, timed
    for (K, N, Ms) in ((896, 4864, (1, 4, 64, 256)),
                       (4864, 896, (1, 4, 64, 256)),
                       (2048, 768, (4, 64)), (768, 2048, (4, 64))):
        n_copies = max(2, -(-2 * L2_BYTES // (K * N * 2)))
        ws = [(torch.randn((K, N), generator=gen, device=dev) / K ** 0.5)
              .to(torch.bfloat16) for _ in range(n_copies)]
        for M in Ms:
            x = torch.randn((M, K), generator=gen, device=dev) \
                .to(torch.bfloat16)
            out = streamed_matmul(x, ws[0])
            e = check_close(f"K1 bf16 ({M},{K})@({K},{N})", out,
                            kref.streamed_matmul_ref(x, ws[0]), "bfloat16")
            max_err = max(max_err, e)
            args = [(x, w) for w in ws]
            ms = time_ms(streamed_matmul, args)
            dev_ms = device_ms(streamed_matmul, args, (MM_MMA,))
            plain_ms = time_ms(kref.streamed_matmul_ref, args)
            lib_ms = time_ms(torch.matmul, args)
            b_ms, b_by = bound(M, K, N, 2, PEAK_BF16_FLOPS)
            shapes.append({"M": M, "K": K, "N": N, "dtype": "bfloat16",
                           "max_abs_err": e, "ms": ms, "device_ms": dev_ms,
                           "plain_ms": plain_ms, "library_ms": lib_ms,
                           "bound_ms": b_ms, "bound_by": b_by,
                           "split": list(sm.split_plan(K, N))})
            log(f"K1 ({M},{K})@({K},{N}) bf16: kernel {ms:.4f} ms (device "
                f"{fmt_ms(dev_ms)}, split {sm.split_plan(K, N)}), plain "
                f"{plain_ms:.4f} ms, torch.matmul {lib_ms:.4f} ms, bound "
                f"{b_ms:.4f} ms ({b_by}), max |err| {e:.3e}")
        del ws
    # row independence: kernel(x)[rows] == kernel(x[rows]) bit for bit,
    # across both tile configurations (M <= 16 and M > 16)
    for (K, N) in ((896, 4864), (4864, 896), (112, 56), (2048, 768),
                   (768, 2048), (2048, 128)):
        for dtype in (torch.bfloat16, torch.float32):
            x = torch.randn((256, K), generator=gen, device=dev).to(dtype)
            w = (torch.randn((K, N), generator=gen, device=dev)
                 / K ** 0.5).to(dtype)
            full = streamed_matmul(x, w)
            for rows in ((0, 1), (3, 4), (0, 4), (5, 21), (100, 164),
                         (0, 256)):
                part = streamed_matmul(x[rows[0]:rows[1]].contiguous(), w)
                if not torch.equal(part, full[rows[0]:rows[1]]):
                    raise AssertionError(
                        f"K1 rows {rows} of ({K},{N}) {dtype} depend on M")
    # and over 600 rows, which the bf16 wrapper launches as slices of 256:
    # slices that cross M = 16 (the two tile heights) and 256 (the slicing)
    for (K, N) in ((896, 4864), (4864, 896), (112, 56)):
        for dtype in (torch.bfloat16, torch.float32):
            x = torch.randn((600, K), generator=gen, device=dev).to(dtype)
            w = (torch.randn((K, N), generator=gen, device=dev)
                 / K ** 0.5).to(dtype)
            full = streamed_matmul(x, w)
            max_err = max(max_err, check_close(
                f"K1 {dtype} (600,{K})@({K},{N})", full,
                kref.streamed_matmul_ref(x, w), str(dtype).split(".")[-1]))
            for rows in ((0, 16), (0, 17), (10, 30), (250, 270), (255, 257),
                         (200, 520), (256, 600), (599, 600)):
                part = streamed_matmul(x[rows[0]:rows[1]].contiguous(), w)
                if not torch.equal(part, full[rows[0]:rows[1]]):
                    raise AssertionError(
                        f"K1 rows {rows} of 600 at ({K},{N}) {dtype} depend "
                        "on M or on the row slicing")
    torch.cuda.synchronize()
    log("K1 row results independent of M: bit for bit (slices of 256 and "
        "600 rows, across M = 16 and the 256-row slicing, bf16 and f32)")
    # split-K on two streams at once: each stream has its own tile
    # counters, so the calls may overlap and still give the same bits
    for (M, K, N) in ((4, 4864, 896), (64, 4864, 896), (300, 896, 4864)):
        x = torch.randn((M, K), generator=gen, device=dev) \
            .to(torch.bfloat16)
        w = (torch.randn((K, N), generator=gen, device=dev) / K ** 0.5) \
            .to(torch.bfloat16)
        want = streamed_matmul(x, w)
        torch.cuda.synchronize()
        streams = [torch.cuda.Stream() for _ in range(2)]
        outs = []
        for st in streams:
            with torch.cuda.stream(st):
                outs += [streamed_matmul(x, w) for _ in range(8)]
        torch.cuda.synchronize()
        if not all(torch.equal(o, want) for o in outs):
            raise AssertionError(f"K1 ({M},{K})@({K},{N}) on two streams "
                                 "at once differs from one stream")
    log("K1 split-K on two streams at once == on one stream, bit for bit")
    return {"max_abs_err": max_err, "shapes": shapes,
            "variant_launches": dict(streamed_matmul.variant_launches),
            "check_launches": streamed_matmul.launches - before}


def _quantise(mode, w, group=None):
    """The port's quantiser of ``mode`` on ``w``; returns the kernel's
    weight operands (codes, scales[, zeros])."""
    from repro_torch.kernels import streamed_matmul as sm
    if mode == "int8":
        return sm.quantize_int8(w, block_k=group or sm.GROUP_SIZE)
    return sm.quantize_int4(w, group_size=group or sm.GROUP_SIZE)


# K2 and K3 in bf16 run on the tensor cores with exact products (their
# codes are integers that bf16 holds) and are held, besides TOL's 2e-2, to
# a limit set by their own rounding. ref32 is the plain version before its
# cast to bf16, x.f32 @ its f32 dequantised weight w, here with the sum
# taken in f64 and rounded once to f32, so that the limit carries the
# kernel's rounding and not the reference's. For an output element, with
# A = sum_k |x_k w_kn| and v the kernel's f32 value:
#   - the bf16 output: |bf16(v) - v| <= 2^-8 |v| <= 2^-8 (|ref32| + T);
#   - the f32 sums: T = n 2^-24 A to first order, n counting the f32
#     roundings a product passes through at 2 units each (2^-23: in case
#     the tensor cores truncate). A product enters a group partial of at
#     most m = ceil(g / 16) + 1 mma steps, each step one operation over 17
#     addends whose alignment and normalisation err by at most 17 units of
#     their absolute sum (the tensor-core model of Fasi, Higham, Mikaitis and
#     Pranesh, 2021): 34 m; then the product by its group's scale: 1; the
#     adds into the split's sum, one per group the split touches,
#     ceil(k_split / g) + 1; the S - 1 adds of the splits' sum; and 2 for
#     ref32's own roundings (of w and of its result). n is capped at K (the
#     first-order bound of any K-term f32 sum), which binds where K is
#     under about 340 and only tightens the limit there.
# The limit is 2^-8 (|ref32| + T) + T. A sound kernel's excess (error /
# limit) stays at most 1; the kernel fed x with one group's K rows zeroed
# (a planted fault), against the unfaulted ref32, must exceed it 5 times.
BF16_OUT = 2.0 ** -8
F32_UNIT = 2.0 ** -24
QUANT_FAULT_MIN = 5.0
# the planted faults' shapes (M, K, N, nominal group): a main-path
# down-projection, and a ragged one whose group boundaries (g = 117) fall
# inside k16 steps
QUANT_FAULTS = ((4, 4864, 896, 128), (17, 700, 96, 128))


def order_units(K, N, g):
    """n of the f32-sum term above for a (K, N) weight in groups of g."""
    from repro_torch.kernels import streamed_matmul as sm
    S, k_split = sm.split_plan(K, N)
    m = -(-g // 16) + 1
    return min(34 * m + 1 + -(-k_split // g) + 1 + S - 1 + 2, K)


def quant_ref32(mode, x, q):
    """(ref32, T) of the limit above for ``x`` against the quantised
    weight ``q`` of ``mode``; both f64 on the card."""
    from repro_torch.kernels import streamed_matmul as sm
    w = (sm.dequant_int8 if mode == "int8" else sm.dequant_int4)(*q)
    K, N = w.shape
    g = -(-K // q[1].shape[0])
    xd, wd = x.double(), w.double()
    T = order_units(K, N, g) * F32_UNIT * (xd.abs() @ wd.abs())
    return (xd @ wd).float().double(), T


def quant_round_excess(out, ref32, T):
    """Max over elements of |out - ref32| / the limit above: at most 1 for
    a sound K2 / K3 in bf16."""
    lim = BF16_OUT * (ref32.abs() + T) + T + 1e-30
    return ((out.double() - ref32).abs() / lim).max().item()


def quant_kernel_phase():
    """K2 and K3 against their plain versions on the card, timed at the
    main path's and qwen3-14b's FFN shapes; ragged and odd groups; bf16 on
    the tensor-core kernel and f32 on the CUDA-core one; bf16 within the
    rounding limit above, which planted faults must exceed; row
    independence over slices and two streams."""
    import torch
    from repro_torch.kernels import ref as kref
    from repro_torch.kernels import streamed_matmul as sm
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(4321)
    kern = {"int8": sm.streamed_matmul_int8, "int4": sm.streamed_matmul_int4}
    plain = {"int8": kref.streamed_matmul_int8_ref,
             "int4": kref.streamed_matmul_int4_ref}
    deq = {"int8": sm.dequant_int8, "int4": sm.dequant_int4}
    before = {m: kern[m].launches for m in QUANT_MODES}
    out = {m: {"max_abs_err": 0.0, "round_excess": 0.0, "shapes": [],
               "faults": []} for m in QUANT_MODES}
    reset_variants()

    def check(mode, tag, x, q):
        y = kern[mode](x, *q)
        e = check_close(f"{mode} {tag}", y, plain[mode](x, *q),
                        str(x.dtype).split(".")[-1])
        out[mode]["max_abs_err"] = max(out[mode]["max_abs_err"], e)
        if x.dtype == torch.bfloat16:
            ex = quant_round_excess(y, *quant_ref32(mode, x, q))
            if not ex <= 1.0:
                raise AssertionError(f"{mode} {tag}: error {ex:.3f}x the "
                                     "rounding limit")
            out[mode]["round_excess"] = max(out[mode]["round_excess"], ex)
            return e, ex
        return e, None

    # the port's quantisers give the same bytes on the card as on the CPU
    # (the CPU's are held byte for byte against the JAX package's by
    # tests/test_torch_quant.py)
    for (K, N) in ((700, 129), (896, 4864), (250, 64)):
        w = torch.randn((K, N), generator=gen, device=dev) \
            .to(torch.bfloat16)
        for mode in QUANT_MODES:
            for a, b in zip(_quantise(mode, w), _quantise(mode, w.cpu())):
                if a.dtype != b.dtype or not torch.equal(a.cpu(), b):
                    raise AssertionError(f"{mode} quantiser on the card "
                                         f"differs from the CPU at "
                                         f"({K},{N})")
    log("quantisers on the card == on the CPU, byte for byte")
    # ragged and odd groups, bf16 and f32 (K=700: 6 groups of 117;
    # K=250: 2 groups of 125, the nibbles of one byte in two groups;
    # g = 5 and g = 3 cut every k16 step, g = 1 is a group a row)
    ragged = ((3, 700, 129, 128), (17, 700, 96, 128), (1, 250, 70, 128),
              (65, 250, 64, 128), (4, 250, 33, 64), (20, 56, 112, 128),
              (5, 4864, 896, 64), (5, 200, 80, 5), (7, 130, 48, 3),
              (3, 64, 64, 1))
    for mode in QUANT_MODES:
        for dtype in (torch.bfloat16, torch.float32):
            for (M, K, N, group) in ragged:
                w = torch.randn((K, N), generator=gen, device=dev)
                x = torch.randn((M, K), generator=gen, device=dev).to(dtype)
                check(mode, f"{dtype} ({M},{K})@({K},{N}) g{group}", x,
                      _quantise(mode, w, group))
        want = {"mma": len(ragged), "fma": len(ragged)}
        if kern[mode].variant_launches != want:
            raise AssertionError(f"{mode} ragged/odd groups took "
                                 f"{kern[mode].variant_launches} != {want}")
        log(f"{mode} ragged/odd groups within tolerance (max |err| "
            f"{out[mode]['max_abs_err']:.3e}); bf16 within the rounding "
            f"limit (max excess {out[mode]['round_excess']:.3f} <= 1); by "
            f"kernel {kern[mode].variant_launches} (bf16 mma, f32 fma)")
    # expert_quant="int8": an expert's matrix as int8 codes with one f32
    # scale, which K2 takes as a single group, the scale broadcast to
    # (1, 1, N) (models/mlp.py), at qwen30b-a3b's expert shapes
    from repro_torch.models import mlp
    for (M, K, N) in ((4, 2048, 768), (64, 2048, 768), (4, 768, 2048),
                      (64, 768, 2048)):
        w = torch.randn((K, N), generator=gen, device=dev) / K ** 0.5
        qe = mlp.quantize_experts_int8(
            {"w_gate": w, "w_up": w, "w_down": w})
        q = (qe["w_gate"], qe["s_gate"].reshape(1, 1, 1).expand(1, 1, N)
             .contiguous())
        for dtype in (torch.bfloat16, torch.float32):
            x = torch.randn((M, K), generator=gen, device=dev).to(dtype)
            check("int8", f"{dtype} ({M},{K})@({K},{N}) one group", x, q)
    log("int8 one group (expert_quant) at the expert shapes within "
        f"tolerance; bf16 within the rounding limit (max excess "
        f"{out['int8']['round_excess']:.3f} <= 1)")
    # the main path's, qwen30b-a3b's expert and qwen3-14b's FFN shapes,
    # bf16, timed
    for (K, N, Ms) in ((896, 4864, (1, 4, 64, 256)),
                       (4864, 896, (1, 4, 64, 256)),
                       (2048, 768, (4, 64)), (768, 2048, (4, 64)),
                       (5120, 17408, (1, 4)), (17408, 5120, (1, 4))):
        w = (torch.randn((K, N), generator=gen, device=dev) / K ** 0.5) \
            .to(torch.bfloat16)
        for mode in QUANT_MODES:
            q = _quantise(mode, w)
            w_bytes = sum(t.numel() * t.element_size() for t in q)
            n_copies = max(2, -(-2 * L2_BYTES // w_bytes))
            qs = [q] + [tuple(t.clone() for t in q)
                        for _ in range(n_copies - 1)]
            wd = deq[mode](*q).to(torch.bfloat16)   # context only
            n_bf16 = max(2, -(-2 * L2_BYTES // (K * N * 2)))
            wds = [wd] + [wd.clone() for _ in range(n_bf16 - 1)]
            for M in Ms:
                x = torch.randn((M, K), generator=gen, device=dev) \
                    .to(torch.bfloat16)
                n_mma = kern[mode].variant_launches["mma"]
                e, ex = check(mode, f"bf16 ({M},{K})@({K},{N})", x, q)
                if kern[mode].variant_launches["mma"] != n_mma + 1:
                    raise AssertionError(f"{mode} ({M},{K})@({K},{N}) bf16 "
                                         "did not take the tensor cores")
                args = [(x,) + qq for qq in qs]
                ms = time_ms(kern[mode], args)
                dev_ms = device_ms(kern[mode], args, (MM_MMA,))
                plain_ms = time_ms(plain[mode], args)
                ctx_ms = time_ms(torch.matmul, [(x, d) for d in wds])
                b_ms, b_by = bound(M, K, N, 2, PEAK_BF16_FLOPS,
                                   w_bytes=w_bytes)
                out[mode]["shapes"].append(
                    {"M": M, "K": K, "N": N, "dtype": "bfloat16",
                     "w_bytes": w_bytes, "max_abs_err": e,
                     "round_excess": ex, "ms": ms, "device_ms": dev_ms,
                     "plain_ms": plain_ms, "library_ms": None,
                     "bf16_matmul_context_ms": ctx_ms, "bound_ms": b_ms,
                     "bound_by": b_by, "split": list(sm.split_plan(K, N))})
                log(f"{mode} ({M},{K})@({K},{N}) bf16 x: kernel {ms:.4f} "
                    f"ms (device {fmt_ms(dev_ms)}), plain {plain_ms:.4f} "
                    f"ms, bound {b_ms:.4f} ms ({b_by}, {w_bytes} weight "
                    f"bytes), max |err| {e:.3e}, {ex:.3f}x the rounding "
                    f"limit; context, not the same function: torch.matmul "
                    f"on the dequantised bf16 weight {ctx_ms:.4f} ms")
            del qs, wds, wd
        del w
        free_cuda()
    # the rounding limit has teeth: the kernel fed x with one group's K
    # rows zeroed, against the unfaulted ref32, must exceed it 5 times;
    # TOL's 2e-2 is printed beside it
    for (M, K, N, group) in QUANT_FAULTS:
        w = torch.randn((K, N), generator=gen, device=dev) / K ** 0.5
        x = torch.randn((M, K), generator=gen, device=dev) \
            .to(torch.bfloat16)
        for mode in QUANT_MODES:
            q = _quantise(mode, w, group)
            ref32, T = quant_ref32(mode, x, q)
            g = -(-K // q[1].shape[0])
            gi = q[1].shape[0] // 2
            bad_x = x.clone()
            bad_x[:, gi * g:min(K, (gi + 1) * g)] = 0
            bad = kern[mode](bad_x, *q)
            ex = quant_round_excess(bad, ref32, T)
            err = (bad.double() - ref32).abs()
            caught = bool((err > TOL["bfloat16"]["atol"]
                           + TOL["bfloat16"]["rtol"] * ref32.abs()).any())
            out[mode]["faults"].append(
                {"shape": [M, K, N], "g": g, "rows_zeroed":
                 [gi * g, min(K, (gi + 1) * g)], "round_excess": ex,
                 "max_abs_err": err.max().item(), "caught_by_2e-2": caught})
            log(f"{mode} planted fault, ({M},{K})@({K},{N}) g{g} with x's "
                f"rows {gi * g}..{min(K, (gi + 1) * g) - 1} zeroed: {ex:.3f}x "
                f"the rounding limit (must be >= {QUANT_FAULT_MIN}), max "
                f"|err| {err.max().item():.3e}; caught by rtol = atol = "
                f"2e-2: {caught}")
            if not ex >= QUANT_FAULT_MIN:
                raise AssertionError(f"{mode} rounding limit has too few "
                                     f"teeth at ({M},{K})@({K},{N}): a "
                                     f"zeroed group reads {ex:.3f}x")
    # row independence: 256 rows in both tile configurations, and 600,
    # which the bf16 wrapper launches as slices of 256: slices that cross
    # M = 16 (the two tile heights) and 256 (the slicing); ragged groups,
    # an expert's shape, and one group (as expert_quant runs K2)
    for mode in QUANT_MODES:
        for (K, N, group) in ((896, 4864, None), (4864, 896, None),
                              (250, 70, None), (2048, 768, None),
                              (2048, 768, 2048)):
            w = torch.randn((K, N), generator=gen, device=dev)
            q = _quantise(mode, w, group)
            for dtype in (torch.bfloat16, torch.float32):
                for M, cuts in ((256, ((0, 1), (3, 4), (0, 4), (5, 21),
                                       (100, 164), (0, 256))),
                                (600, ((0, 16), (0, 17), (10, 30),
                                       (250, 270), (255, 257), (200, 520),
                                       (256, 600), (599, 600)))):
                    x = torch.randn((M, K), generator=gen, device=dev) \
                        .to(dtype)
                    full = kern[mode](x, *q)
                    if M == 600:
                        check(mode, f"{dtype} (600,{K})@({K},{N})", x, q)
                    for rows in cuts:
                        part = kern[mode](x[rows[0]:rows[1]].contiguous(), *q)
                        if not torch.equal(part, full[rows[0]:rows[1]]):
                            raise AssertionError(
                                f"{mode} rows {rows} of {M} at ({K},{N}) "
                                f"{dtype} depend on M or on the row slicing")
    torch.cuda.synchronize()
    log("K2, K3 row results independent of M: bit for bit (slices of 256 "
        "and 600 rows, across M = 16 and the 256-row slicing, ragged "
        "groups, bf16 and f32)")
    # split-K on two streams at once: each stream has its own tile counters
    for mode in QUANT_MODES:
        for (M, K, N) in ((4, 4864, 896), (64, 4864, 896), (300, 896, 4864),
                          (17, 700, 96)):
            w = torch.randn((K, N), generator=gen, device=dev) / K ** 0.5
            q = _quantise(mode, w)
            x = torch.randn((M, K), generator=gen, device=dev) \
                .to(torch.bfloat16)
            want = kern[mode](x, *q)
            torch.cuda.synchronize()
            streams = [torch.cuda.Stream() for _ in range(2)]
            outs = []
            for st in streams:
                with torch.cuda.stream(st):
                    outs += [kern[mode](x, *q) for _ in range(8)]
            torch.cuda.synchronize()
            if not all(torch.equal(o, want) for o in outs):
                raise AssertionError(f"{mode} ({M},{K})@({K},{N}) on two "
                                     "streams at once differs from one")
    log("K2, K3 split-K on two streams at once == on one stream, bit for "
        "bit")
    for m in QUANT_MODES:
        out[m]["check_launches"] = kern[m].launches - before[m]
        out[m]["variant_launches"] = dict(kern[m].variant_launches)
        log(f"{m} bf16 within the rounding limit at every shape: max "
            f"excess {out[m]['round_excess']:.3f} <= 1")
    return out


# ------------------------------------------------------------ phase 2: K4
# (B, H, KV, Tq, Tk, hd)
FLASH_SWEEP = ((1, 4, 4, 128, 128, 64), (2, 8, 2, 256, 256, 64),
               (1, 6, 2, 192, 192, 128))            # tests/test_kernels.py
VISION_SHAPE = (1, 16, 16, 4641, 4641, 80)          # 720p encoder layer
LANGUAGE_SHAPE = (1, 28, 4, 4096, 4096, 128)        # qwen2-vl-7b, T=4096
VISION_Q_CHUNK = 663        # the reference's Q-chunk at N = 4641
KNOB_TOL = 2e-5             # tests/test_kernels.py::test_flash_q_chunk_knob


def flash_bound(shape, causal, dtype_bytes, flops_peak):
    """Least ms for one attention call: q, k, v read once and o written
    once over the HBM rate, or 4 * hd operations per visible (query, key)
    pair (two products) over ``flops_peak``; causal counts the pairs this
    shape's mask leaves, min(i + 1, Tk) for row i."""
    B, H, KV, Tq, Tk, hd = shape
    if causal:
        n = min(Tq, Tk)
        pairs = n * (n + 1) // 2 + max(Tq - Tk, 0) * Tk
    else:
        pairs = Tq * Tk
    t_ops = 4.0 * B * H * hd * pairs / flops_peak * 1e3
    byts = (2 * B * H * Tq + 2 * B * KV * Tk) * hd * dtype_bytes
    t_bytes = byts / PEAK_HBM_BPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# K4 in bf16 on the tensor cores is also held to a limit set by its own
# rounding, since TOL's 2e-2 is about a typical |o| at the path's lengths
# (|o| ~ 0.02 at N = 4641), where a lost kv tile could pass. The kernel
# rounds p to bf16 (unit roundoff 2^-8) before p @ v, with l summing the
# f32 p, and rounds its output to bf16. Against the f32 attention o of the
# same bf16 inputs an element's error is then at most 2^-8 |o| from the
# output's rounding plus sum_j d_j v_j / l, |d_j| <= 2^-8 p_j, from p's:
# independent roundings of scale 2^-8 sqrt(sum_j p_j^2 v_j^2) / l. The
# limit allows twice the first and 8 times the scale of the second (which
# bounds the second outright for rows of up to 64 visible keys, by
# Cauchy-Schwarz), plus 1e-5 for the f32 sums' order. A sound kernel's
# excess (max error / limit) stays at most 1; a planted fault, one kv tile
# dropped, must go above it.
BF16_ROUND = 2.0 ** -8
P_ROUND_SCALES = 8.0
F32_ORDER = 1e-5
# the planted faults: (tag, shape, causal, block_k, keys dropped). Each
# drops the last kv tile: the vision shape's chunk of 545 keys ends in a
# ragged tile of 33, the language shape's last chunk in a whole tile of
# 64, the ragged length's third chunk is one tile of 33
PLANTED_FAULTS = (("vision", (1, 16, 16, 4641, 4641, 80), False, 1024, 33),
                  ("language", (1, 28, 4, 4096, 4096, 128), True, 1024, 64),
                  ("ragged", (1, 28, 4, 2081, 2081, 128), True, 1024, 33))


def attention_f32(q, k, v, causal):
    """The plain version's attention (``kernels/ref.py``) in f32 without
    its final cast: o, and sqrt(p^2 @ v^2), the scale of p's rounding."""
    import torch
    from repro_torch.kernels.ref import NEG_INF
    B, H, Tq, hd = q.shape
    KV, Tk = k.shape[1], k.shape[2]
    qg = q.reshape(B, KV, H // KV, Tq, hd).float()
    s = torch.einsum("bkgtd,bksd->bkgts", qg, k.float()) * hd ** -0.5
    if causal:
        mask = torch.arange(Tk, device=q.device)[None, :] \
            <= torch.arange(Tq, device=q.device)[:, None]
        s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    del s
    vf = v.float()
    o = torch.einsum("bkgts,bksd->bkgtd", p, vf)
    r = torch.einsum("bkgts,bksd->bkgtd", p.square_(), vf.square()).sqrt_()
    return o.reshape(B, H, Tq, hd), r.reshape(B, H, Tq, hd)


def p_round_excess(out, o, r):
    """Max over elements of |out - o| / the bf16-p limit (see
    ``BF16_ROUND``): at most 1 for a sound tensor-core K4."""
    lim = 2 * BF16_ROUND * o.abs() + P_ROUND_SCALES * BF16_ROUND * r \
        + F32_ORDER
    return ((out.float() - o).abs() / lim).max().item()


def check_p_round(name, out, q, k, v, causal):
    """Gate a bf16 tensor-core K4 output against the bf16-p limit;
    returns its excess."""
    x = p_round_excess(out, *attention_f32(q, k, v, causal))
    if not x <= 1.0:
        raise AssertionError(f"{name}: error {x:.3f}x the bf16-p limit")
    return x


def _qkv(gen, shape, dtype, n_sets=1):
    """``n_sets`` independent (q, k, v) on the card."""
    import torch
    B, H, KV, Tq, Tk, hd = shape
    return [tuple(torch.randn(s, generator=gen, device="cuda").to(dtype)
                  for s in ((B, H, Tq, hd), (B, KV, Tk, hd), (B, KV, Tk, hd)))
            for _ in range(n_sets)]


def flash_kernel_phase():
    """K4 against its plain version on the card: the sweep, the VLM
    path's shapes (timed), a ragged causal length, Tq != Tk, and the
    Q-chunk knob."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.ref import flash_attention_ref
    gen = torch.Generator(device="cuda").manual_seed(2024)
    before = fa.flash_attention.launches
    reset_variants()
    max_err = 0.0
    shapes, checked = [], []
    dtypes = (torch.bfloat16, torch.float32)

    def check(tag, shape, dtype, causal, bq=64, bk=64):
        (q, k, v), = _qkv(gen, shape, dtype)
        out = fa.flash_attention(q, k, v, causal=causal, block_q=bq,
                                 block_k=bk)
        dname = str(dtype).split(".")[-1]
        name = f"K4 {tag} {shape} {dtype} causal={causal}"
        e = check_close(name, out,
                        flash_attention_ref(q, k, v, causal=causal), dname)
        entry = {"tag": tag, "shape": list(shape), "dtype": dname,
                 "causal": causal, "block_q": bq, "block_k": bk,
                 "max_abs_err": e}
        if dtype == torch.bfloat16:
            entry["p_round_excess"] = check_p_round(name, out, q, k, v,
                                                    causal)
        checked.append(entry)
        return e

    for shape in FLASH_SWEEP:
        for dtype in dtypes:
            for causal in (True, False):
                max_err = max(max_err, check("sweep", shape, dtype, causal))
    # ragged: no chunk divides 2081; Tq != Tk both ways (positions from 0)
    for shape, causal, bq, bk in (((1, 28, 4, 2081, 2081, 128), True,
                                   1024, 1024),
                                  ((1, 8, 2, 300, 1000, 128), True, 128, 128),
                                  ((1, 8, 2, 1000, 300, 80), True, 663, 1024),
                                  ((1, 8, 2, 300, 1000, 64), False, 64, 64)):
        for dtype in dtypes:
            max_err = max(max_err, check("ragged", shape, dtype, causal, bq,
                                         bk))
    excess = max(c.get("p_round_excess", 0.0) for c in checked)
    log(f"K4 sweep, ragged and Tq != Tk shapes within tolerance (max |err| "
        f"{max_err:.3e}); bf16 within the bf16-p limit (max excess "
        f"{excess:.3f} <= 1)")
    # bf16 on the tensor cores, f32 on the CUDA cores, every shape
    n_each = len(checked) // 2
    want = {"mma": n_each, "fma": n_each}
    if fa.flash_attention.variant_launches != want:
        raise AssertionError(f"K4 sweep and ragged shapes took "
                             f"{fa.flash_attention.variant_launches} != "
                             f"{want}")
    log(f"K4 sweep, ragged and Tq != Tk shapes by kernel: "
        f"{fa.flash_attention.variant_launches} (bf16 mma, f32 fma)")
    # the path's shapes, bf16, timed over copies larger than the L2
    for tag, shape, causal, bq, bk in (
            ("vision", VISION_SHAPE, False, VISION_Q_CHUNK, 1024),
            ("language", LANGUAGE_SHAPE, True, 1024, 1024)):
        B, H, KV, Tq, Tk, hd = shape
        set_bytes = (2 * B * H * Tq + 2 * B * KV * Tk) * hd * 2
        sets = _qkv(gen, shape, torch.bfloat16,
                    max(2, -(-2 * L2_BYTES // set_bytes)))
        q, k, v = sets[0]
        n_mma = fa.flash_attention.variant_launches["mma"]
        e = check_close(f"K4 {tag} {shape}",
                        fa.flash_attention(q, k, v, causal=causal,
                                           block_q=bq, block_k=bk),
                        flash_attention_ref(q, k, v, causal=causal),
                        "bfloat16")
        if fa.flash_attention.variant_launches["mma"] != n_mma + 1:
            raise AssertionError(f"K4 {tag} {shape} bf16 did not take the "
                                 "tensor-core kernel")
        x = check_p_round(f"K4 {tag} {shape}", fa.flash_attention(
            q, k, v, causal=causal, block_q=bq, block_k=bk), q, k, v, causal)
        max_err = max(max_err, e)
        ms = time_ms(lambda q, k, v: fa.flash_attention(
            q, k, v, causal=causal, block_q=bq, block_k=bk), sets, iters=10)
        dev_ms = device_ms(lambda q, k, v: fa.flash_attention(
            q, k, v, causal=causal, block_q=bq, block_k=bk), sets,
            (FLASH_MMA,), iters=10)
        plain_ms = time_ms(lambda q, k, v: flash_attention_ref(
            q, k, v, causal=causal), sets, iters=10)
        lib_ms = time_ms(lambda q, k, v: F.scaled_dot_product_attention(
            q, k, v, is_causal=causal, enable_gqa=True), sets, iters=10)
        b_ms, b_by = flash_bound(shape, causal, 2, PEAK_BF16_FLOPS)
        shapes.append({"tag": tag, "shape": list(shape), "causal": causal,
                       "block_q": bq, "block_k": bk, "dtype": "bfloat16",
                       "max_abs_err": e, "p_round_excess": x, "ms": ms,
                       "device_ms": dev_ms, "plain_ms": plain_ms,
                       "library_ms": lib_ms, "bound_ms": b_ms,
                       "bound_by": b_by})
        log(f"K4 {tag} {shape} causal={causal} bf16: kernel {ms:.4f} ms "
            f"(device {fmt_ms(dev_ms)}), "
            f"plain {plain_ms:.4f} ms, scaled_dot_product_attention "
            f"{lib_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}), max |err| "
            f"{e:.3e}, {x:.3f}x the bf16-p limit")
        del sets, q, k, v
        free_cuda()
    # the bf16-p limit has teeth: the kernel run without its last kv tile
    # (a planted fault) must exceed it; TOL's 2e-2 is printed beside it
    faults = []
    for tag, shape, causal, bk, drop in PLANTED_FAULTS:
        (q, k, v), = _qkv(gen, shape, torch.bfloat16)
        o, r = attention_f32(q, k, v, causal)
        bad = fa.flash_attention(q, k[:, :, :-drop], v[:, :, :-drop],
                                 causal=causal, block_q=64, block_k=bk)
        x = p_round_excess(bad, o, r)
        err = (bad.float() - o).abs()
        caught_by_tol = bool((err > TOL["bfloat16"]["atol"]
                              + TOL["bfloat16"]["rtol"] * o.abs()).any())
        faults.append({"tag": tag, "shape": list(shape), "dropped": drop,
                       "p_round_excess": x,
                       "max_abs_err": err.max().item(),
                       "caught_by_2e-2": caught_by_tol})
        log(f"K4 planted fault, {tag} {shape} without its last {drop} "
            f"keys: {x:.3f}x the bf16-p limit (must be > 1), max |err| "
            f"{err.max().item():.3e}; caught by rtol = atol = 2e-2: "
            f"{caught_by_tol}")
        if not x > 1.0:
            raise AssertionError(f"K4 bf16-p limit has no teeth: a dropped "
                                 f"kv tile at {tag} {shape} passes ({x:.3f})")
        del q, k, v, o, r, bad, err
    free_cuda()
    # the language shape in f32 as well: at bf16's limit of 2e-2, about a
    # typical |o| at this length, a lost kv tile could still pass
    e32 = check("language", LANGUAGE_SHAPE, torch.float32, True, 1024, 1024)
    max_err = max(max_err, e32)
    log(f"K4 language {LANGUAGE_SHAPE} causal f32: max |err| {e32:.3e} "
        f"within rtol {TOL['float32']['rtol']} / atol "
        f"{TOL['float32']['atol']}")
    # VLMOpt's knob: K4 tiles the query axis itself, block_q is only checked
    (q, k, v), = _qkv(gen, VISION_SHAPE, torch.float32)
    outs = {bq: fa.flash_attention(q, k, v, causal=False, block_q=bq,
                                   block_k=1024)
            for bq in (64, 128, VISION_Q_CHUNK)}
    ref = outs[VISION_Q_CHUNK]
    max_err = max(max_err, check_close(
        f"K4 vision {VISION_SHAPE} f32", ref,
        flash_attention_ref(q, k, v, causal=False), "float32"))
    knob = max((o - ref).abs().max().item() for o in outs.values())
    bit_equal = all(torch.equal(o, ref) for o in outs.values())
    if knob > KNOB_TOL:
        raise AssertionError(f"K4 results depend on block_q: {knob:.3e} > "
                             f"{KNOB_TOL}")
    log(f"K4 block_q 64, 128, {VISION_Q_CHUNK} at {VISION_SHAPE} f32: max "
        f"|diff| {knob:.3e} <= {KNOB_TOL}; bit-equal: {bit_equal}")
    del q, k, v, outs, ref
    # the same in bf16, on the tensor-core kernel: bit-equal is the gate
    (q, k, v), = _qkv(gen, VISION_SHAPE, torch.bfloat16)
    outs = {bq: fa.flash_attention(q, k, v, causal=False, block_q=bq,
                                   block_k=1024)
            for bq in (64, 128, VISION_Q_CHUNK)}
    ref = outs[VISION_Q_CHUNK]
    bf16_equal = all(torch.equal(o, ref) for o in outs.values())
    if not bf16_equal:
        raise AssertionError("K4 bf16 results depend on block_q")
    log(f"K4 block_q 64, 128, {VISION_Q_CHUNK} at {VISION_SHAPE} bf16: "
        f"bit-equal: {bf16_equal}")
    del q, k, v, outs, ref
    free_cuda()
    return {"max_abs_err": max_err, "shapes": shapes, "checked": checked,
            "planted_faults": faults, "block_q_max_diff": knob,
            "block_q_bit_equal": bit_equal,
            "block_q_bit_equal_bf16": bf16_equal,
            "variant_launches": dict(fa.flash_attention.variant_launches),
            "check_launches": fa.flash_attention.launches - before}


# ------------------------------------------------------------ phase 3-5
def measure_link_gbps(nbytes=256 * 2 ** 20, reps=5):
    import torch
    host = torch.empty(nbytes, dtype=torch.uint8).pin_memory()
    dev = torch.empty(nbytes, dtype=torch.uint8, device="cuda")
    dev.copy_(host, non_blocking=True)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        dev.copy_(host, non_blocking=True)
    end.record()
    end.synchronize()
    return nbytes * reps / (start.elapsed_time(end) / 1e3) / 1e9


def free_cuda():
    import torch
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def expected_streamed_by_dtype(ex):
    """The ledger, by storage format (``meta["quant"]``): every pass
    streams exactly its tier plan's streamed placements that are not
    pinned."""
    out = {}
    pinned = set(ex._pinned)
    for t in ex.stats.tiers_used:
        for p in ex.schedule.tiers[t].plan.static_stream_order():
            if p.sub.name not in pinned:
                q = p.sub.meta.get("quant", "fp16")
                out[q] = out.get(q, 0) + p.sub.weight_bytes
    return out


def memory_bound(sess):
    """Peak device bytes the plan allows, with everything the executor
    keeps outside the planned budget counted in. For MoE: the at-use term
    covers the router, expert and whole-MoE sub-layers, and the (E, C, d)
    dispatch and output buffers are counted at the most rows C the run
    held at once (``ExecStats.moe_rows_peak``)."""
    from repro_torch.core.prefetch import groups_nbytes
    from repro_torch.models.common import tree_nbytes
    ex = sess.executor
    cfg = sess.cfg
    # the schedule's canonical pinned bytes, so an executor that pins more
    # than its plan cannot raise its own bound. The graph prices the
    # matrices only; the norms and biases pinned with them (141 KB at
    # qwen2-0.5b's full width) fall under the activation allowance.
    placements = sess.schedule.pinned_placements()
    pinned = int(sum(pl.sub.weight_bytes for pl in placements))
    if set(ex._pinned) != {pl.sub.name for pl in placements}:
        raise AssertionError(f"executor pins {sorted(ex._pinned)}, the "
                             f"schedule {[pl.sub.name for pl in placements]}")
    tiers = set(ex.stats.tiers_used) or set(sess.schedule.tiers)
    scratch = max(sess.schedule.tiers[t].scratch_bytes for t in tiers)
    at_use = max(groups_nbytes(ex._subtree(s)) for s in sess.subs
                 if s.kind in ("attn", "ffn", "moe", "moe_router",
                               "moe_expert"))
    kv = 2 * cfg.n_layers * MAX_BATCH * cfg.n_kv_heads * MAX_SEQ \
        * cfg.resolved_head_dim * 2
    resident = tree_nbytes({k: ex.host[k] for k in ex.host})
    parts = {"pinned": pinned, "scratch": scratch, "at_use_one_sublayer":
             at_use, "kv": kv, "embed_norm_head": resident,
             "activations": ACT_ALLOWANCE}
    if cfg.moe is not None:
        parts["moe_dispatch_and_output"] = \
            2 * cfg.moe.n_experts * ex.stats.moe_rows_peak * cfg.d_model * 2
    return sum(parts.values()), parts


def serve_once(cfg, params, db, system, budget, *, overlap=True,
               fused=True, prefill_mode=None, rebudget_to=None,
               rebudget_after=2, n_req=N_REQ, new_tokens=NEW_TOKENS,
               expert_granular=None):
    import torch
    from repro_torch import Session
    from repro_torch.core import InferenceSetting, random_requests
    free_cuda()
    torch.cuda.reset_peak_memory_stats()
    sess = Session.open(cfg, system=system, budget_bytes=budget,
                        setting=InferenceSetting(batch=MAX_BATCH,
                                                 context=MAX_SEQ),
                        db=db, params=params, max_seq=MAX_SEQ,
                        overlap=overlap, prefill_mode=prefill_mode,
                        expert_granular=expert_granular)
    # build the executor (weights placed on the card) before the requests
    # arrive, so TTFT counts serving and not set-up
    batcher = sess.batcher(max_batch=MAX_BATCH, fused=fused)
    torch.cuda.synchronize()
    reqs = random_requests(cfg.vocab, n_req, PROMPT_LEN, new_tokens, seed=0)
    t0 = time.perf_counter()
    diff = None
    steps = []          # (seconds, tokens emitted, prefills in the step)
    batcher.submit(reqs)
    while batcher.has_work:
        if rebudget_to is not None and len(steps) == rebudget_after:
            diff = sess.update_budget(rebudget_to)
        n_pref = len(batcher.ex.stats.prefill_stats)
        ts = time.perf_counter()
        events = batcher.step()
        torch.cuda.synchronize()
        steps.append((time.perf_counter() - ts, len(events),
                      len(batcher.ex.stats.prefill_stats) - n_pref))
    wall = time.perf_counter() - t0
    tokens = [list(r.generated) for r in reqs]
    return {"sess": sess, "tokens": tokens, "wall": wall, "diff": diff,
            "peak": torch.cuda.max_memory_allocated(), "reqs": reqs,
            "steps": steps}


def summarise(tag, run):
    sess = run["sess"]
    st = sess.stats()
    ex = st["executor"]
    # decode-only steps: no admission (prefill) ran in them
    dec = [(dt, n) for dt, n, pref in run["steps"] if pref == 0]
    dec_s = sum(dt for dt, _ in dec)
    row = {"budget": tag, "ttft_s": st["serving"]["mean_ttft_s"],
           "decode_tps": sum(n for _, n in dec) / max(dec_s, 1e-9),
           "decode_step_ms": 1e3 * dec_s / max(len(dec), 1),
           "wall_s": run["wall"],
           "streamed_mb": ex["streamed_bytes"] / 1e6,
           "streamed_mb_by_dtype": {
               k: v / 1e6 for k, v in ex["streamed_bytes_by_dtype"].items()},
           "staged_mb": ex["staged_bytes"] / 1e6,
           "copy_s_hidden": ex["copy_s_hidden"],
           "copy_s_exposed": ex["copy_s_exposed"],
           "at_use_mb": ex["at_use_bytes"] / 1e6,
           "at_use_s": ex["at_use_s"],
           "tiers": st["serving"]["tiers_used"],
           "plans": {t: sess.schedule.tiers[t].plan.name
                     for t in st["serving"]["tiers_used"]},
           "peak_mb": run["peak"] / 1e6}
    if "expert_hit_rate" in ex:
        passes = sess.executor.stats.pass_expert_stats
        row.update({
            "expert_hit_rate": ex["expert_hit_rate"],
            "demanded_expert_mb": ex["demanded_expert_bytes"] / 1e6,
            "demanded_mb_per_decode_step": sum(
                p["demanded_bytes"] for p in passes) / max(len(passes), 1)
            / 1e6,
            "resident_expert_mb": ex["resident_expert_bytes"] / 1e6,
            "demand_slots": (sess.executor.prefetch.stats.demand_slots
                             if sess.executor.prefetch is not None else 0)})
    by_dtype = "{" + ", ".join(f"{k}: {v:.1f}" for k, v in
                               row["streamed_mb_by_dtype"].items()) + "}"
    log(f"budget {tag}: TTFT {row['ttft_s']:.4f} s, decode "
        f"{row['decode_tps']:.2f} tok/s ({row['decode_step_ms']:.2f} ms per "
        f"step of {MAX_BATCH}), streamed {row['streamed_mb']:.1f} "
        f"MB {by_dtype}, staged {row['staged_mb']:.1f} MB, copy hidden "
        f"{row['copy_s_hidden']:.4f} s / exposed "
        f"{row['copy_s_exposed']:.4f} s, at use {row['at_use_mb']:.1f} MB "
        f"waited {row['at_use_s']:.4f} s, tiers {row['tiers']} "
        f"{row['plans']}, peak {row['peak_mb']:.1f} MB")
    if "expert_hit_rate" in row:
        log(f"  experts: hit rate {row['expert_hit_rate']:.4f}, demanded "
            f"{row['demanded_expert_mb']:.1f} MB "
            f"({row['demanded_mb_per_decode_step']:.1f} MB per decode "
            f"step), resident {row['resident_expert_mb']:.1f} MB, demand "
            f"slots {row['demand_slots']}")
    return row


def _device_model_params(cfg, params):
    """``params`` on the card for the monolithic forward. An MoE model's
    layers go as a list of per-layer trees with each expert a tree of its
    own (``mlp.split_experts``), so no (E, ...) stack lands on the card."""
    from repro_torch.models import mlp
    from repro_torch.models.common import tree_map
    from repro_torch.models.transformer import layer_slice
    if cfg.moe is None:
        return tree_map(lambda t: t.to("cuda"), params)
    layers = []
    for i in range(cfg.n_layers):
        lp = layer_slice(params["layers"], i)
        lp["moe"] = mlp.split_experts(lp["moe"])
        layers.append(tree_map(lambda t: t.to("cuda"), lp))
    return {**{k: v.to("cuda") for k, v in params.items() if k != "layers"},
            "layers": layers}


def teacher_forced_check(cfg, params, tokens, prompts):
    """The served tokens against the port's monolithic forward on the card:
    every served token must be the argmax of the monolithic logits at its
    position, up to the near-tie margin ``TF_GAP``. The forward's FFNs are
    plain math: the dense FFN runs through torch.matmul on bf16 weights,
    dequantised to bf16 where they are quantised, the served one through
    K1, K2 or K3; an MoE layer routes with ``torch.matmul`` in f32 and
    runs each expert as ``plain_expert_ffn``, so no streamed-matmul kernel
    launches in the forward (checked), and a fault in the served MoE layer
    shows here."""
    import torch
    from repro_torch.models import build_model, mlp
    dev_params = _device_model_params(cfg, params)
    model = build_model(cfg)
    worst = 0.0
    before = read_launches()
    for prompt, gen in zip(prompts, tokens):
        seq = torch.as_tensor(list(prompt) + gen[:-1], dtype=torch.int32,
                              device="cuda")[None]
        with torch.no_grad(), \
                _Swap(mlp, "expert_ffn", plain_expert_ffn), \
                _Swap(mlp, "streamed_matmul", torch.matmul):
            logits, _ = model.apply(dev_params, {"tokens": seq})
        if tuple(logits.shape) != (1, seq.shape[1], cfg.vocab):
            raise AssertionError(f"logits shape {tuple(logits.shape)}")
        if not bool(torch.isfinite(logits).all()):
            raise AssertionError("non-finite monolithic logits")
        z = logits[0, len(prompt) - 1:].float()
        picked = z.gather(1, torch.as_tensor(gen, device="cuda")[:, None])
        gap = (z.max(dim=1).values - picked[:, 0]).max().item()
        worst = max(worst, gap)
    del model, dev_params
    free_cuda()
    after = read_launches()
    if any(after[k] != before[k] for k in ("K1", "K2", "K3")):
        raise AssertionError(f"the plain forward launched kernels: "
                             f"{before} -> {after}")
    if worst > TF_GAP:
        raise AssertionError(f"served tokens disagree with the monolithic "
                             f"forward: logit gap {worst:.4f} > {TF_GAP}")
    return worst


def main_path():
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import SYSTEMS, build_graph, run_install, \
        total_weight_bytes
    from repro_torch.core.executor import pin_host_tree
    from repro_torch.models import build_model

    cfg = get_config("qwen2-0.5b")
    link = measure_link_gbps()
    system = SYSTEMS["h100"].with_(link_gbps=link)
    log(f"pinned host->device link: {link:.2f} GB/s (CUDA events, 256 MiB)")
    t0 = time.perf_counter()
    params = build_model(cfg).init(torch.Generator().manual_seed(0))
    params = pin_host_tree(params, torch.device("cuda"))
    log(f"qwen2-0.5b full width ({cfg.n_layers} layers, d={cfg.d_model}, "
        f"f={cfg.d_ff}, vocab={cfg.vocab}): weights made and pinned in "
        f"{time.perf_counter() - t0:.1f} s")
    db = run_install(system)
    total = total_weight_bytes(build_graph(cfg))
    runs, rows = {}, []

    # warm-up: one short request, so the timed runs below do not pay the
    # card's first-use costs (library and module loading)
    run = serve_once(cfg, params, db, system, int(total * 2.0), n_req=1,
                     new_tokens=2)
    run["sess"].close()
    del run

    # ---- phase 3: the main path, launches counted over exactly this run
    reset_launches()
    for frac in BUDGETS:
        run = serve_once(cfg, params, db, system, int(total * frac))
        rows.append(summarise(f"{frac}x", run))
        ex = run["sess"].executor
        want = sum(expected_streamed_by_dtype(ex).values())
        if ex.stats.streamed_bytes != want:
            raise AssertionError(f"{frac}x: streamed ledger "
                                 f"{ex.stats.streamed_bytes} != plan {want}")
        lim, parts = memory_bound(run["sess"])
        log(f"  peak device memory {run['peak']} B <= bound {lim} B "
            f"{parts}")
        if run["peak"] > lim:
            raise AssertionError(f"{frac}x: peak {run['peak']} > {lim}")
        run["streamed_bytes"] = ex.stats.streamed_bytes
        del ex              # the next budget's peak must not see this one
        run["sess"].close()
        runs[frac] = run
    counts = read_launches()
    variants = read_variants()
    main_launches = counts["K1"]
    if counts["K2"] or counts["K3"]:
        raise AssertionError(f"quantised kernels ran on the bf16 path: "
                             f"{counts}")
    if variants["K1"] != {"mma": main_launches, "fma": 0}:
        raise AssertionError(f"K1 on the bf16 main path: {variants['K1']}, "
                             f"not all {main_launches} on the tensor cores")
    base = runs[2.0]["tokens"]
    for frac in BUDGETS:
        if runs[frac]["tokens"] != base:
            raise AssertionError(f"tokens at {frac}x differ from 2.0x")
    log("tokens identical across budgets 2.0x, 0.5x, 0.1x: True")
    streamed_01 = runs[0.1]["streamed_bytes"]
    if streamed_01 <= 0:
        raise AssertionError("nothing streamed at 0.1x")
    if main_launches <= 0:
        raise AssertionError("K1 was never launched on the main path")
    log(f"K1 launches on the main path: {main_launches} (by kernel "
        f"{variants['K1']})")
    gap = teacher_forced_check(cfg, params, base,
                               [r.prompt for r in runs[2.0]["reqs"]])
    log(f"served tokens == monolithic greedy under teacher forcing "
        f"(max logit gap {gap:.4f})")

    # ---- phase 4: live re-budget 2.0x -> 0.1x mid-serve
    run = serve_once(cfg, params, db, system, int(total * 2.0),
                     rebudget_to=int(total * 0.1))
    ex = run["sess"].executor
    diff = run["diff"]
    if diff is None:
        raise AssertionError("the serve drained before the re-budget")
    if run["tokens"] != base:
        raise AssertionError("tokens after live re-budget differ")
    if (ex.stats.rebind_pinned_bytes, ex.stats.rebind_evicted_bytes) != \
            (diff.pin_bytes, diff.evict_bytes):
        raise AssertionError("rebind moved bytes != Schedule.diff")
    log(f"live re-budget 2.0x -> 0.1x: tokens identical, evicted "
        f"{diff.evict_bytes} B == Schedule.diff, pinned {diff.pin_bytes} B")
    del ex
    run["sess"].close()

    # ---- phase 5: the baselines at 0.1x, each against the served tokens
    for tag, kw in (("sync", dict(overlap=False)),
                    ("per-slot", dict(fused=False)),
                    ("chunk-major", dict(prefill_mode="chunk_major"))):
        run = serve_once(cfg, params, db, system, int(total * 0.1), **kw)
        rows.append(summarise(f"0.1x-{tag}", run))
        if run["tokens"] != runs[0.1]["tokens"]:
            raise AssertionError(f"{tag} tokens differ from the 0.1x run")
        log(f"{tag} == pipelined fused layer-major at 0.1x: tokens "
            "identical")
        run["sess"].close()

    # ---- phase 6: where the decode time goes at 0.1x
    prof = profile_phase(cfg, params, db, system, int(total * 0.1))

    # ---- phase 7: the quantised main paths
    quant = {mode: quant_path(cfg, params, db, system, mode, base)
             for mode in QUANT_MODES}
    for mode in QUANT_MODES:
        agree = quant[mode].pop("agreement")
        log(f"{mode} greedy tokens equal to the bf16 run's: {agree:.3f} of "
            "positions (information only: random weights quantise badly)")
    return {"rows": rows, "launches": main_launches, "variants": variants,
            "link_gbps": link,
            "profile": prof, "quant": quant}


KERNEL_OF = {"int8": "K2", "int4": "K3"}


def _counters():
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import streamed_matmul as sm
    return {"K1": sm.streamed_matmul, "K2": sm.streamed_matmul_int8,
            "K3": sm.streamed_matmul_int4, "K4": fa.flash_attention}


def reset_launches():
    for fn in _counters().values():
        fn.launches = 0
    reset_variants()


def read_launches():
    return {name: fn.launches for name, fn in _counters().items()}


def reset_variants():
    """Every kernel's launches per variant: ``"mma"`` (tensor cores, bf16)
    and ``"fma"`` (CUDA cores) back to 0."""
    for fn in _counters().values():
        for key in fn.variant_launches:
            fn.variant_launches[key] = 0


def read_variants():
    return {name: dict(fn.variant_launches)
            for name, fn in _counters().items()}


class _CallCount:
    """Counts the calls of ``module.name`` while installed."""

    def __init__(self, module, name):
        self.module, self.name, self.real = module, name, getattr(module,
                                                                   name)
        self.calls = 0

    def __enter__(self):
        def counted(*a, **kw):
            self.calls += 1
            return self.real(*a, **kw)
        setattr(self.module, self.name, counted)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.real)
        return False


class _Swap:
    """``module.name`` replaced by ``fn`` while installed."""

    def __init__(self, module, name, fn):
        self.module, self.name, self.fn = module, name, fn
        self.real = getattr(module, name)

    def __enter__(self):
        setattr(self.module, self.name, self.fn)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.real)
        return False


def plain_expert_ffn(p_e, rows):
    """One expert as plain math, for the forward the served tokens are
    held against: each weight dequantised to the rows' dtype by
    ``mlp._dequant``, then ``torch.matmul``, as the dense monolithic FFN
    computes; no kernel of the port runs."""
    from repro_torch.models import mlp
    gate = rows @ mlp._dequant(p_e, "w_gate", rows.dtype)
    up = rows @ mlp._dequant(p_e, "w_up", rows.dtype)
    return mlp._silu_mul(gate, up) @ mlp._dequant(p_e, "w_down", rows.dtype)


def quantised_params(params, mode):
    """``params`` with every layer's FFN quantised by the port's
    quantisers, on the card, then copied back to pinned host memory; the
    other leaves are shared, so every mode serves the same weights."""
    import torch
    from repro_torch.core.executor import pin_host_tree
    from repro_torch.models.transformer import quantize_params
    ffn = {k: v.to("cuda") for k, v in params["layers"]["ffn"].items()}
    q = quantize_params({"layers": {"ffn": ffn}}, mode)["layers"]["ffn"]
    q = pin_host_tree({k: v.cpu() for k, v in q.items()},
                      torch.device("cuda"))
    del ffn
    free_cuda()
    return {**params, "layers": {**params["layers"], "ffn": q}}


def quant_path(cfg, params, db, system, mode, base):
    """Phase 7 for one ``weight_quant`` mode; ``base`` is the bf16 run's
    tokens (for the information-only agreement share)."""
    from repro_torch.core import build_graph, total_weight_bytes
    from repro_torch.models import mlp
    t0 = time.perf_counter()
    qparams = quantised_params(params, mode)
    qcfg = cfg.replace(weight_quant=mode)
    total = total_weight_bytes(build_graph(qcfg))
    log(f"{mode}: FFN weights quantised on the card in "
        f"{time.perf_counter() - t0:.1f} s; weight bytes {total} B")
    kname = KERNEL_OF[mode]
    runs, rows = {}, []
    ffn_calls = 0
    # launches counted over exactly this mode's main-path run
    reset_launches()
    with _CallCount(mlp, "_dequant") as dequant:
        for frac in QUANT_BUDGETS:
            run = serve_once(qcfg, qparams, db, system, int(total * frac))
            rows.append(summarise(f"{mode} {frac}x", run))
            ex = run["sess"].executor
            by = dict(ex.stats.streamed_bytes_by_dtype)
            want = expected_streamed_by_dtype(ex)
            if by != want or sum(by.values()) != ex.stats.streamed_bytes:
                raise AssertionError(f"{mode} {frac}x: streamed by dtype "
                                     f"{by} != plan {want} (total "
                                     f"{ex.stats.streamed_bytes})")
            lim, parts = memory_bound(run["sess"])
            log(f"  peak device memory {run['peak']} B <= bound {lim} B "
                f"{parts}")
            if run["peak"] > lim:
                raise AssertionError(f"{mode} {frac}x: peak {run['peak']} "
                                     f"> {lim}")
            # every layer runs one attention and one FFN sub-layer call
            ffn_calls += sum(ex.stats.engine_calls.values()) // 2
            run["by_dtype"] = by
            del ex
            run["sess"].close()
            runs[frac] = run
    counts = read_launches()
    variants = read_variants()
    want_counts = {k: 0 for k in counts}
    want_counts[kname] = 3 * ffn_calls      # gate, up, down per FFN call
    if counts != want_counts:
        raise AssertionError(f"{mode}: launches {counts} != {want_counts} "
                             f"(three {kname} per FFN call, nothing else)")
    if variants[kname] != {"mma": counts[kname], "fma": 0}:
        raise AssertionError(f"{mode}: {kname} by kernel {variants[kname]}, "
                             f"not all {counts[kname]} on the tensor cores")
    if dequant.calls:
        raise AssertionError(f"{mode}: the served path called _dequant "
                             f"{dequant.calls} times")
    log(f"{kname} launches on the {mode} main path: {counts[kname]} == 3 x "
        f"{ffn_calls} FFN calls (by kernel {variants[kname]}); K1 and the "
        "other kernel 0; _dequant 0")
    tokens = runs[2.0]["tokens"]
    for frac in QUANT_BUDGETS:
        if runs[frac]["tokens"] != tokens:
            raise AssertionError(f"{mode}: tokens at {frac}x differ from "
                                 "2.0x")
    log(f"{mode} tokens identical across budgets "
        f"{', '.join(f'{f}x' for f in QUANT_BUDGETS)}: True")
    by01 = runs[0.1]["by_dtype"]
    if by01.get(mode, 0) <= 0:
        raise AssertionError(f"{mode}: no FFN bytes streamed at 0.1x "
                             f"({by01})")
    log(f"{mode} streamed at 0.1x by dtype: {by01} B == the plan's ledger")
    gap = teacher_forced_check(qcfg, qparams, tokens,
                               [r.prompt for r in runs[2.0]["reqs"]])
    log(f"{mode} served tokens == monolithic greedy under teacher forcing "
        f"(max logit gap {gap:.4f})")
    flat = [t for seq in tokens for t in seq]
    flat_base = [t for seq in base for t in seq]
    agree = sum(a == b for a, b in zip(flat, flat_base)) / len(flat_base)
    prof = None
    if mode == "int4":
        for tag, kw in (("sync", dict(overlap=False)),
                        ("per-slot", dict(fused=False))):
            run = serve_once(qcfg, qparams, db, system, int(total * 0.1),
                             **kw)
            rows.append(summarise(f"{mode} 0.1x-{tag}", run))
            if run["tokens"] != runs[0.1]["tokens"]:
                raise AssertionError(f"{mode} {tag} tokens differ from the "
                                     "0.1x run")
            log(f"{mode} {tag} == pipelined fused at 0.1x: tokens "
                "identical")
            run["sess"].close()
        prof = profile_phase(qcfg, qparams, db, system, int(total * 0.1),
                             tag=f"{mode} 0.1x")
    return {"rows": rows, "launches": counts[kname],
            "variants": variants[kname], "total_bytes": total,
            "teacher_forced_gap": gap, "agreement": agree,
            "profile": prof}


def profile_phase(cfg, params, db, system, budget, steps=4, tag="0.1x"):
    """Device time by kernel over ``steps`` fused decode iterations of a
    full batch, and the share of the window's wall time in which the card
    ran a kernel (copies run on their own stream and are listed apart)."""
    import torch
    from repro_torch import Session
    from repro_torch.core import InferenceSetting, random_requests
    free_cuda()
    sess = Session.open(cfg, system=system, budget_bytes=budget,
                        setting=InferenceSetting(batch=MAX_BATCH,
                                                 context=MAX_SEQ),
                        db=db, params=params, max_seq=MAX_SEQ)
    b = sess.batcher(max_batch=MAX_BATCH)
    b.submit(random_requests(cfg.vocab, N_REQ, PROMPT_LEN, NEW_TOKENS,
                             seed=0))
    b.step()                      # admissions (prefill) and a first decode
    b.step()
    torch.cuda.synchronize()

    def decode_steps():
        for _ in range(steps):
            b.step()
    events, wall_us = profiled(decode_steps, host=True)
    b.serve([])
    sess.close()
    kernels, copies, host_ops = {}, {}, {}
    launches = 0
    for e in events:
        if e.device_type != torch.autograd.DeviceType.CUDA:
            host_ops[e.key] = e.self_cpu_time_total
        elif e.key.lower().startswith("memcpy"):
            copies[e.key] = e.self_device_time_total
        else:
            kernels[e.key] = e.self_device_time_total
            launches += e.count
    busy = sum(kernels.values())
    if busy <= 0:
        log("profile: the profiler saw no device time (not measured)")
        return None
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:8]
    top_host = sorted(host_ops.items(), key=lambda kv: -kv[1])[:6]
    mm_us = kernel_us(events, (MM_MMA, MM_FMA))
    out = {"steps": steps, "wall_ms_per_step": wall_us / steps / 1e3,
           "kernel_ms_per_step": busy / steps / 1e3,
           "kernel_launches_per_step": launches / steps,
           "busy_share": busy / wall_us, "mm_share_of_kernel_time":
           mm_us / busy, "copy_ms_per_step": sum(copies.values()) / steps
           / 1e3, "host_op_ms_per_step": sum(host_ops.values()) / steps
           / 1e3, "top": [{"kernel": k[:80], "ms_per_step": us / steps / 1e3}
                          for k, us in top],
           "top_host": [{"op": k[:80], "ms_per_step": us / steps / 1e3}
                        for k, us in top_host]}
    log(f"profile {tag} decode: {out['wall_ms_per_step']:.2f} ms per step, "
        f"{out['kernel_launches_per_step']:.0f} kernels taking "
        f"{out['kernel_ms_per_step']:.3f} ms (busy share "
        f"{out['busy_share']:.3f}), streamed matmuls "
        f"{out['mm_share_of_kernel_time']:.3f} "
        f"of kernel time, copies {out['copy_ms_per_step']:.3f} ms, host "
        f"time inside torch ops {out['host_op_ms_per_step']:.2f} ms")
    for row in out["top"]:
        log(f"  {row['ms_per_step']:.4f} ms/step  {row['kernel']}")
    for row in out["top_host"]:
        log(f"  host {row['ms_per_step']:.4f} ms/step  {row['op']}")
    return out


def k4_profile(tag, fn):
    """K4's share of the device's kernel time over one call of ``fn``,
    from ``torch.profiler`` (memory copies left out), and of the profiled
    window's wall time, which the profiler inflates. Printed only."""
    free_cuda()
    events, wall_us = profiled(fn, host=True)
    busy = kernel_us(events)
    k4 = kernel_us(events, (FLASH_MMA, FLASH_FMA))
    if busy <= 0:
        log(f"profile {tag}: the profiler saw no device time (not "
            "measured)")
        return None
    out = {"wall_ms": wall_us / 1e3, "kernel_ms": busy / 1e3,
           "k4_ms": k4 / 1e3, "k4_share_of_kernel_time": k4 / busy,
           "busy_share": busy / wall_us}
    log(f"profile {tag}: K4 {out['k4_ms']:.2f} ms of {out['kernel_ms']:.2f} "
        f"ms of kernel time (share {out['k4_share_of_kernel_time']:.3f}); "
        f"profiled wall {out['wall_ms']:.2f} ms, busy share "
        f"{out['busy_share']:.3f}")
    return out


# ------------------------------------------------------------ phase 8-10
VLM_GEN_STEPS = 16
VLM_TEXT_TOKENS = 3072
F32_REL_TOL = 1e-3    # f32 encoder, flash against plain, over max |out|
# the bf16 encoder, flash against plain: 32 layers of bf16 rounding, in
# which K4 rounds p to bf16 and the plain attention does not. Readings on
# the H100: max |diff| / max |out| 2.326e-02 before the tensor-core K4 and
# after, rms |diff| / rms |out| 1.175e-02. The limits catch a gross fault
# only; a lost kv tile moves these gaps less than the rounding does, so
# each layer's K4 is held to the bf16-p limit on its own inputs as well
ENC_BF16_MAX = 5e-2
ENC_BF16_RMS = 2e-2


def layer_excess(fn, drop=0):
    """Run ``fn`` with every K4 launch checked against the bf16-p limit on
    its own q, k, v (``p_round_excess``); with ``drop`` the kernel runs
    without the last ``drop`` keys (a planted fault). Returns one excess
    per launch."""
    from repro_torch.kernels import flash_attention as fa
    real, out = fa.launch, []

    def checked(q, k, v, o, **kw):
        kk, vv = (k, v) if not drop else (k[:, :, :-drop], v[:, :, :-drop])
        res = real(q, kk, vv, o, **kw)
        out.append(p_round_excess(o, *attention_f32(q, k, v, kw["causal"])))
        return res
    fa.launch = checked
    try:
        fn()
    finally:
        fa.launch = real
    return out


def _encode(vlmopt, vc, params, res, dtype, flash):
    """One encode of seeded patches at ``res``; returns (out, seconds,
    peak bytes). The peak counts everything allocated, weights
    included. The patches are a temporary: the encoder overwrites them
    with its residual stream and returns them."""
    import torch
    n = vlmopt.n_vision_tokens(vc, res)
    pg = torch.Generator(device="cuda").manual_seed(1)
    patches = torch.randn((1, n, vc.d), generator=pg, device="cuda") \
        .to(dtype)
    free_cuda()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = vlmopt.vision_encode(params, vc, patches, flash=flash)
    del patches
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    if tuple(out.shape) != (1, n, vc.d) or not bool(
            torch.isfinite(out).all()):
        raise AssertionError(f"{res} encode: shape {tuple(out.shape)} or "
                             "non-finite values")
    return out, dt, peak


def encode_gaps(out, ref):
    """(max |out - ref| / max |ref|, rms |out - ref| / rms |ref|)."""
    d = out.float() - ref.float()
    r = ref.float()
    return ((d.abs().max() / r.abs().max()).item(),
            (d.square().mean().sqrt() / r.square().mean().sqrt()).item())


def vision_path():
    """Phase 8: the VLMOpt encoder at full width on the card."""
    import torch
    from repro_torch.core import vlmopt
    from repro_torch.models.common import tree_nbytes
    vc = vlmopt.VisionConfig()
    t0 = time.perf_counter()
    params = vlmopt.init_vision_params(
        torch.Generator(device="cuda").manual_seed(0), vc, torch.bfloat16)
    torch.cuda.synchronize()
    wbytes = vlmopt.vision_weight_bytes(vc)
    log(f"vision encoder (d={vc.d}, {vc.layers} layers, {vc.heads} heads, "
        f"hd={vc.d // vc.heads}): {tree_nbytes(params)} B of bf16 weights "
        f"({wbytes} B of matrices) drawn on the card in "
        f"{time.perf_counter() - t0:.1f} s")
    n = vlmopt.n_vision_tokens(vc, "720p")
    score_bytes = vc.heads * n * n * 4
    q_chunks = -(-n // 1024)     # K4 launches per layer: one per Q-chunk
    # warm-up (library loading), outside the counted run
    vlmopt.vision_encode(params, vc, torch.zeros(
        (1, 64, vc.d), dtype=torch.bfloat16, device="cuda"), flash=True)
    reset_launches()
    flash, t_flash, peak_flash = _encode(vlmopt, vc, params, "720p",
                                         torch.bfloat16, True)
    counts = read_launches()
    variants = read_variants()["K4"]
    want = {name: 0 for name in counts}
    want["K4"] = vc.layers * q_chunks
    if counts != want:
        raise AssertionError(f"720p encode launches {counts} != {want}")
    if variants != {"mma": want["K4"], "fma": 0}:
        raise AssertionError(f"720p bf16 encode: K4 by kernel {variants}, "
                             "not all on the tensor cores")
    plain, t_plain, peak_plain = _encode(vlmopt, vc, params, "720p",
                                         torch.bfloat16, False)
    bf16_rel, bf16_rms = encode_gaps(flash, plain)
    # every layer's K4 launch of one more encode against the bf16-p limit
    # on that layer's own q, k and v; then a planted fault, each launch
    # without the last kv tile (the 33 keys that end the last chunk)
    sound = layer_excess(lambda: _encode(vlmopt, vc, params, "720p",
                                         torch.bfloat16, True))
    bad_out = []
    bad = layer_excess(lambda: bad_out.append(_encode(
        vlmopt, vc, params, "720p", torch.bfloat16, True)[0]), drop=33)
    bad_rel, bad_rms = encode_gaps(bad_out.pop(), plain)
    del flash, plain
    log(f"720p bf16 encode, flash vs plain: max |diff| / max |out| "
        f"{bf16_rel:.3e} <= {ENC_BF16_MAX}, rms |diff| / rms |out| "
        f"{bf16_rms:.3e} <= {ENC_BF16_RMS}; each layer's K4 at most "
        f"{max(sound):.3f}x the bf16-p limit (<= 1)")
    log(f"  planted fault (K4 without the last 33 keys in every layer): "
        f"each layer's K4 at least {min(bad):.3f}x the bf16-p limit (must "
        f"be > 1); encode gaps {bad_rel:.3e}, {bad_rms:.3e} (not gated: "
        f"32 layers of bf16 rounding hide one lost tile)")
    if not (bf16_rel <= ENC_BF16_MAX and bf16_rms <= ENC_BF16_RMS):
        raise AssertionError(f"720p bf16 encode: flash vs plain "
                             f"{bf16_rel:.3e}, {bf16_rms:.3e} beyond "
                             f"{ENC_BF16_MAX}, {ENC_BF16_RMS}")
    if len(sound) != want["K4"] or not max(sound) <= 1.0:
        raise AssertionError(f"720p bf16 encode: K4 layers at "
                             f"{sound} x the bf16-p limit")
    if len(bad) != want["K4"] or not min(bad) > 1.0:
        raise AssertionError(f"the per-layer bf16-p gate has no teeth: a "
                             f"planted fault reads {bad}")
    prof = k4_profile("720p encode", lambda: _encode(
        vlmopt, vc, params, "720p", torch.bfloat16, True))
    demand = {f: vlmopt.vision_vram_demand(vc, "720p", offload=False,
                                           flash=f) for f in (True, False)}
    log(f"720p encode (N={n}): K4 launches {counts['K4']} == {vc.layers} "
        f"layers x {q_chunks} Q-chunks (by kernel {variants}); flash "
        f"{t_flash:.4f} s, plain {t_plain:.4f} s; peak "
        f"flash {peak_flash} B <= analytic {demand[True]} B, plain "
        f"{peak_plain} B <= analytic {demand[False]} B")
    for tag, peak, lim in (("flash", peak_flash, demand[True]),
                           ("plain", peak_plain, demand[False])):
        if peak > lim:
            raise AssertionError(f"720p {tag} encode peak {peak} B > "
                                 f"vision_vram_demand {lim} B")
    if peak_flash - wbytes >= score_bytes:
        raise AssertionError(f"flash encode peak - weights "
                             f"{peak_flash - wbytes} B >= the N^2 scores "
                             f"{score_bytes} B")
    if peak_plain - wbytes < score_bytes:
        raise AssertionError(f"plain encode peak - weights "
                             f"{peak_plain - wbytes} B < the N^2 scores "
                             f"{score_bytes} B: the check has no teeth")
    log(f"  peak - weights: flash {peak_flash - wbytes} B < {score_bytes} "
        f"B (16 N^2 f32 scores) <= plain {peak_plain - wbytes} B")
    # f32 weights: flash == plain up to the order of sums
    p32 = {k: v.float() for k, v in params.items()}
    reset_variants()
    f32_flash, _, _ = _encode(vlmopt, vc, p32, "720p", torch.float32, True)
    variants32 = read_variants()["K4"]
    if variants32 != {"mma": 0, "fma": vc.layers * q_chunks}:
        raise AssertionError(f"720p f32 encode: K4 by kernel {variants32}, "
                             "not all on the CUDA cores")
    f32_plain, _, _ = _encode(vlmopt, vc, p32, "720p", torch.float32, False)
    rel = ((f32_flash - f32_plain).abs().max()
           / f32_plain.abs().max()).item()
    del p32, f32_flash, f32_plain
    if rel > F32_REL_TOL:
        raise AssertionError(f"f32 encoder: flash vs plain {rel:.3e} > "
                             f"{F32_REL_TOL}")
    log(f"720p f32 encoder: flash vs plain max |diff| / max |out| "
        f"{rel:.3e} <= {F32_REL_TOL}; K4 by kernel {variants32}")
    # 1440p, flash only (its plain scores alone would be 22 GB per layer)
    n1440 = vlmopt.n_vision_tokens(vc, "1440p")
    out, t_1440, peak_1440 = _encode(vlmopt, vc, params, "1440p",
                                     torch.bfloat16, True)
    del out
    demand_1440 = vlmopt.vision_vram_demand(vc, "1440p", offload=False,
                                            flash=True)
    log(f"1440p encode (N={n1440}) through K4: {t_1440:.4f} s, peak "
        f"{peak_1440} B <= analytic {demand_1440} B")
    if peak_1440 > demand_1440:
        raise AssertionError(f"1440p flash encode peak {peak_1440} B > "
                             f"vision_vram_demand {demand_1440} B")
    del params
    free_cuda()
    return {"launches": counts["K4"], "variant_launches": variants,
            "variant_launches_f32": variants32, "n_720p": n,
            "encode_s_720p": t_flash, "plain_encode_s_720p": t_plain,
            "peak_flash_720p": peak_flash, "peak_plain_720p": peak_plain,
            "demand_flash_720p": demand[True],
            "demand_plain_720p": demand[False], "score_bytes": score_bytes,
            "weight_bytes": wbytes, "bf16_rel_diff": bf16_rel,
            "bf16_rms_diff": bf16_rms, "layer_p_round_excess": sound,
            "planted_fault_layer_excess": bad,
            "planted_fault_rel_diff": bad_rel,
            "planted_fault_rms_diff": bad_rms,
            "f32_rel_diff": rel, "n_1440p": n1440, "encode_s_1440p": t_1440,
            "peak_1440p": peak_1440, "demand_flash_1440p": demand_1440,
            "profile_720p": prof}


def _vlm_inputs(cfg):
    """1024 seeded vision embeddings (at the token embedding's scale) and
    3072 seeded text tokens; vision token i at (0, i // 32, i % 32), text
    token j at 32 + j on all three axes."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(1)
    nv, d = cfg.n_vision_tokens, cfg.d_model
    vis = (torch.randn((1, nv, d), generator=g, device="cuda")
           * d ** -0.5).to(torch.bfloat16)
    text = torch.randint(0, cfg.vocab, (1, VLM_TEXT_TOKENS), generator=g,
                         device="cuda", dtype=torch.int32)
    i = torch.arange(nv, device="cuda")
    vpos = torch.stack([torch.zeros_like(i), i // 32, i % 32])
    tpos = (32 + torch.arange(VLM_TEXT_TOKENS, device="cuda"))[None] \
        .expand(3, -1)
    pos = torch.cat([vpos, tpos], dim=1)[:, None].to(torch.int32)
    return {"tokens": text, "vision_embeds": vis, "positions": pos}


def _gap(z, tokens):
    """Largest (top logit - the token's logit) over rows of z."""
    picked = z.gather(1, tokens[:, None])[:, 0]
    return (z.max(dim=1).values - picked).max().item()


def language_path():
    """Phase 9: qwen2-vl-7b at full width on the card."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import attention, build_model
    from repro_torch.models.common import greedy_token, tree_nbytes
    cfg = get_config("qwen2-vl-7b")
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    log(f"qwen2-vl-7b ({cfg.n_layers} layers, d={cfg.d_model}, "
        f"{cfg.n_heads}/{cfg.n_kv_heads} heads, hd={cfg.resolved_head_dim}, "
        f"f={cfg.d_ff}, vocab {cfg.vocab}, M-RoPE): {tree_nbytes(params)} B "
        f"of bf16 weights drawn on the card in "
        f"{time.perf_counter() - t0:.1f} s")
    batch = _vlm_inputs(cfg)
    T = cfg.n_vision_tokens + VLM_TEXT_TOKENS
    # warm-up below the flash threshold, outside the counted run
    model.apply(params, {"tokens": batch["tokens"][:, :64],
                         "positions": batch["positions"][:, :, 1024:1088]})

    def forward(b):
        free_cuda()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        logits, _ = model.apply(params, b)
        torch.cuda.synchronize()
        return (logits, time.perf_counter() - t0,
                torch.cuda.max_memory_allocated())

    # (a) the no-cache forward at T = 4096 through K4
    reset_launches()
    logits, t_a, peak_a = forward(batch)
    counts = read_launches()
    variants = read_variants()["K4"]
    want = {name: 0 for name in counts}
    want["K4"] = cfg.n_layers
    if counts != want:
        raise AssertionError(f"forward at T={T}: launches {counts} != "
                             f"{want}")
    if variants != {"mma": cfg.n_layers, "fma": 0}:
        raise AssertionError(f"forward at T={T}: K4 by kernel {variants}, "
                             "not all on the tensor cores")
    if tuple(logits.shape) != (1, T, cfg.vocab) or not bool(
            torch.isfinite(logits).all()):
        raise AssertionError(f"forward: logits {tuple(logits.shape)} or "
                             "non-finite")
    a_tail = logits[0, -64:].float()
    del logits
    # (a) with the plain attention, for its peak memory
    threshold = attention.FLASH_THRESHOLD
    attention.FLASH_THRESHOLD = 1 << 40
    try:
        logits, t_plain, peak_plain = forward(batch)
    finally:
        attention.FLASH_THRESHOLD = threshold
    plain_gap = _gap(logits[0, -64:].float(), a_tail.argmax(dim=1))
    del logits
    log(f"forward at T={T}: K4 launches {counts['K4']} == {cfg.n_layers} "
        f"layers (by kernel {variants}); {t_a:.4f} s, peak {peak_a} B; "
        f"plain attention "
        f"{t_plain:.4f} s, peak {peak_plain} B (K4's argmax within "
        f"{plain_gap:.4f} of the plain forward's top logit)")
    if peak_a >= peak_plain:
        raise AssertionError(f"flash forward peak {peak_a} B >= plain "
                             f"{peak_plain} B")
    prof = k4_profile(f"forward at T={T}", lambda: forward(batch))
    # each layer's K4 launch of one more forward against the bf16-p limit
    # on that layer's own q, k and v
    layers = layer_excess(lambda: forward(batch))
    if len(layers) != cfg.n_layers or not max(layers) <= 1.0:
        raise AssertionError(f"forward at T={T}: K4 layers at {layers} x "
                             "the bf16-p limit")
    log(f"forward at T={T}: each layer's K4 at most {max(layers):.3f}x the "
        f"bf16-p limit (<= 1)")
    # the cached prefill's logits (apply with cache, cache_pos=0)
    cache = model.init_cache(1, T + VLM_GEN_STEPS)
    logits, _ = model.apply(params, batch, cache=cache, cache_pos=0)
    gap_a = _gap(logits[0, -64:].float(), a_tail.argmax(dim=1))
    del logits, cache
    if gap_a > TF_GAP:
        raise AssertionError(f"no-cache (K4) argmax vs cached prefill: "
                             f"logit gap {gap_a:.4f} > {TF_GAP}")
    log(f"no-cache forward (K4) argmax at the last 64 positions within "
        f"{gap_a:.4f} <= {TF_GAP} of the cached prefill's top logit")
    # (b) Model.prefill into a cache of T + 16, then 16 greedy decode steps
    cache = model.init_cache(1, T + VLM_GEN_STEPS)
    free_cuda()
    t0 = time.perf_counter()
    last, cache = model.prefill(params, batch, cache)
    torch.cuda.synchronize()
    t_b = time.perf_counter() - t0
    gen = [greedy_token(last[:, -1])]
    t0 = time.perf_counter()
    for s in range(VLM_GEN_STEPS):
        p = VLM_TEXT_TOKENS + 32 + s      # the new token's 3D position
        step = {"tokens": gen[-1][:, None],
                "positions": torch.full((3, 1, 1), p, dtype=torch.int32,
                                        device="cuda")}
        logits, cache = model.decode_step(params, step, cache, T + s)
        gen.append(greedy_token(logits[:, -1]))
    torch.cuda.synchronize()
    t_dec = time.perf_counter() - t0
    gen = torch.cat(gen)                  # (17,) tokens
    del cache, logits
    # (c) one no-cache forward over the prompt and the generated tokens
    n_new = VLM_GEN_STEPS
    new_pos = (VLM_TEXT_TOKENS + 32 + torch.arange(n_new, device="cuda")) \
        .to(torch.int32)[None, None].expand(3, 1, n_new)
    full = {"tokens": torch.cat([batch["tokens"], gen[None, :n_new]], dim=1),
            "vision_embeds": batch["vision_embeds"],
            "positions": torch.cat([batch["positions"], new_pos], dim=2)}
    logits, _, _ = forward(full)
    gap_c = _gap(logits[0, T - 1:T + n_new].float(), gen.to(torch.int64))
    del logits
    if gap_c > TF_GAP:
        raise AssertionError(f"greedy decode vs the no-cache forward: "
                             f"logit gap {gap_c:.4f} > {TF_GAP}")
    tps = VLM_GEN_STEPS / t_dec
    log(f"prefill (Model.prefill, T={T}) {t_b:.4f} s; {VLM_GEN_STEPS} "
        f"decode steps {tps:.2f} tok/s; the {len(gen)} greedy tokens within "
        f"{gap_c:.4f} <= {TF_GAP} of the no-cache forward's top logit "
        f"under teacher forcing")
    del params, batch, full
    free_cuda()
    return {"launches": counts["K4"], "variant_launches": variants, "T": T,
            "layer_p_round_excess": layers, "forward_s": t_a,
            "forward_peak": peak_a, "plain_forward_s": t_plain,
            "plain_forward_peak": peak_plain, "prefill_s": t_b,
            "decode_tps": tps, "gap_vs_cached": gap_a,
            "gap_teacher_forced": gap_c, "gap_vs_plain": plain_gap,
            "profile_forward": prof}


def vlm_planning(link):
    """Phase 10: qwen2-vl-7b's language stack planned on the h100."""
    from repro_torch import Session
    from repro_torch.configs import get_config
    from repro_torch.core import SYSTEMS, InferenceSetting, run_install
    cfg = get_config("qwen2-vl-7b")
    system = SYSTEMS["h100"].with_(link_gbps=link)
    db = run_install(system)
    out = {}
    for gb in (4, 8):
        sess = Session.open(cfg, system, int(gb * 1e9),
                            InferenceSetting(batch=1, context=4096), db=db)
        est = sess.estimates(4096)
        out[f"{gb}GB"] = est
        log(f"qwen2-vl-7b planning-only session, h100, {gb} GB: pinned "
            f"{est['pinned_bytes']} B, est TTFT(4096) {est['ttft_s']:.4f} "
            f"s, est {est['tps']:.2f} tok/s")
    return out


# ------------------------------------------------------------ phase 11
MOE_ARCH = "qwen30b-a3b"
MOE_LAYERS = 12          # of 48: every layer has the same shapes
MOE_BUDGETS = (2.0, 0.5, 0.1)
# the quantised MoE modes: (tag, config change, the kernel its experts take)
MOE_QUANT = (("int8-experts", dict(expert_quant="int8"), "K2"),
             ("int4", dict(weight_quant="int4"), "K3"))


def _pinned(shape, dtype, fill=None):
    import torch
    t = torch.empty(shape, dtype=dtype, pin_memory=True)
    if fill is not None:
        t.fill_(fill)
    return t


def moe_host_params(cfg):
    """Seeded bf16 weights (f32 router) in the reference's stacked layout
    in pinned host memory, each matrix drawn on the card by the port's
    ``dense_init`` and copied back: no (E, d, f) stack is made on the
    card."""
    import torch
    from repro_torch.models import attention as attn
    from repro_torch.models.common import dense_init
    gen = torch.Generator(device="cuda").manual_seed(0)
    L, d, V = cfg.n_layers, cfg.d_model, cfg.vocab
    E, f = cfg.moe.n_experts, cfg.moe.d_expert
    bf = torch.bfloat16
    first = attn.init_attn_params(gen, cfg, bf)
    layers = {"ln1": _pinned((L, d), bf, 1.0), "ln2": _pinned((L, d), bf, 1.0),
              "attn": {k: _pinned((L,) + tuple(v.shape), v.dtype)
                       for k, v in first.items()},
              "moe": {"router": _pinned((L, d, E), torch.float32),
                      "w_gate": _pinned((L, E, d, f), bf),
                      "w_up": _pinned((L, E, d, f), bf),
                      "w_down": _pinned((L, E, f, d), bf)}}
    for i in range(L):
        a = first if i == 0 else attn.init_attn_params(gen, cfg, bf)
        for k, v in a.items():
            layers["attn"][k][i].copy_(v)
        moe = layers["moe"]
        moe["router"][i].copy_(dense_init(gen, (d, E), 0, torch.float32))
        for e in range(E):
            for k, shape in (("w_gate", (d, f)), ("w_up", (d, f)),
                             ("w_down", (f, d))):
                moe[k][i, e].copy_(dense_init(gen, shape, 0, bf))
    embed = _pinned((V, d), bf)
    embed.copy_(dense_init(gen, (V, d), 1, bf))
    unembed = _pinned((d, V), bf)
    unembed.copy_(dense_init(gen, (d, V), 0, bf))
    return {"embed": embed, "layers": layers, "unembed": unembed,
            "final_norm": _pinned((d,), bf, 1.0)}


def moe_quantised(params, kw):
    """``params`` with every expert quantised by the port's quantisers
    (``expert_quant="int8"`` or ``weight_quant="int4"``) one expert at a
    time on the card, into pinned host memory; other leaves shared."""
    import torch
    from repro_torch.models import mlp
    moe = params["layers"]["moe"]
    L, E = moe["w_gate"].shape[:2]
    out = None
    for i in range(L):
        for e in range(E):
            tree = {k: moe[k][i, e].to("cuda")
                    for k in ("w_gate", "w_up", "w_down")}
            q = mlp.quantize_experts_int8(tree) \
                if kw.get("expert_quant") == "int8" \
                else mlp.quantize_weight_tree(tree, kw["weight_quant"])
            if out is None:
                out = {k: _pinned((L, E) + tuple(v.shape), v.dtype)
                       for k, v in q.items()}
            for k, v in q.items():
                out[k][i, e].copy_(v)
    torch.cuda.synchronize()
    return {**params, "layers": {**params["layers"],
                                 "moe": {"router": moe["router"], **out}}}


def moe_run_checks(tag, run, cfg):
    """One MoE run's gates: the ledger (streamed == static plan +
    demanded expert bytes, per dtype), peak memory within the bound, and
    each decode step's demanded experts per layer <= active tokens x
    top_k. Returns the summary row."""
    row = summarise(tag, run)
    sess = run["sess"]
    ex = sess.executor
    by = dict(ex.stats.streamed_bytes_by_dtype)
    want = expected_streamed_by_dtype(ex)
    if ex.stats.demanded_expert_bytes:
        q = next(s.meta["quant"] for s in sess.subs
                 if s.kind == "moe_expert")
        want[q] = want.get(q, 0) + ex.stats.demanded_expert_bytes
    if by != want or sum(by.values()) != ex.stats.streamed_bytes:
        raise AssertionError(f"{tag}: streamed by dtype {by} != static plan "
                             f"+ demanded experts {want}")
    lim, parts = memory_bound(sess)
    log(f"  peak device memory {run['peak']} B <= bound {lim} B {parts}")
    if run["peak"] > lim:
        raise AssertionError(f"{tag}: peak {run['peak']} > {lim}")
    worst = 0
    for ps in ex.stats.pass_expert_stats:
        cap = ps["n_active"] * cfg.moe.top_k
        if len(ps["layer_demanded"]) != cfg.n_layers \
                or max(ps["layer_demanded"]) > cap:
            raise AssertionError(f"{tag}: a decode step demanded "
                                 f"{ps['layer_demanded']} experts per layer, "
                                 f"more than {cap}")
        worst = max(worst, max(ps["layer_demanded"]) / cap)
    log(f"  ledger: streamed {ex.stats.streamed_bytes} B == static plan + "
        f"{ex.stats.demanded_expert_bytes} B demanded {by}; demanded per "
        f"decode step and layer at most {worst:.3f} of active tokens x "
        f"top_k")
    row.update({"streamed_bytes": ex.stats.streamed_bytes,
                "streamed_bytes_by_dtype": by,
                "demanded_expert_bytes": ex.stats.demanded_expert_bytes,
                "expert_demanded": ex.stats.expert_demanded,
                "expert_hits": ex.stats.expert_hits,
                "bound_bytes": lim, "bound_parts": parts,
                "max_layer_demand_share": worst})
    return row


def moe_path(link):
    """Phase 11: qwen30b-a3b at its published widths, 12 of 48 layers,
    served expert-granular and monolithic, in bf16 and quantised."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import SYSTEMS, build_graph, run_install, \
        total_weight_bytes
    from repro_torch.models import mlp
    cfg = get_config(MOE_ARCH).replace(n_layers=MOE_LAYERS)
    system = SYSTEMS["h100"].with_(link_gbps=link)
    db = run_install(system)
    t0 = time.perf_counter()
    params = moe_host_params(cfg)
    torch.cuda.synchronize()
    m = cfg.moe
    log(f"{MOE_ARCH} at its published widths (d={cfg.d_model}, "
        f"{cfg.n_heads}/{cfg.n_kv_heads} heads, hd={cfg.resolved_head_dim}, "
        f"{m.n_experts} experts top-{m.top_k}, d_expert={m.d_expert}, "
        f"vocab={cfg.vocab}), {cfg.n_layers} of 48 layers: weights drawn "
        f"on the card and pinned in {time.perf_counter() - t0:.1f} s")

    def totals(c):
        return {g: total_weight_bytes(build_graph(c, expert_granular=g))
                for g in (True, False)}

    def serve(c, p, tot, tag, frac, **kw):
        granular = kw.pop("expert_granular", True)
        run = serve_once(c, p, db, system, int(tot[granular] * frac),
                         expert_granular=granular, **kw)
        row = moe_run_checks(f"moe {tag} {frac}x", run, c)
        row["tokens"] = run["tokens"]
        row["prompts"] = [r.prompt for r in run["reqs"]]
        del run["sess"]
        free_cuda()
        return row

    tot = totals(cfg)
    # warm-up, outside the counted run
    warm = serve_once(cfg, params, db, system, int(tot[True] * 2.0),
                      n_req=1, new_tokens=2)
    warm["sess"].close()
    del warm
    free_cuda()
    rows = {}
    runs = [("granular", f, {}) for f in MOE_BUDGETS] \
        + [("monolithic", f, dict(expert_granular=False))
           for f in MOE_BUDGETS[:2]] \
        + [("granular-sync", 0.1, dict(overlap=False))]
    reset_launches()
    with _CallCount(mlp, "_route") as route, \
            _CallCount(mlp, "expert_ffn") as experts:
        for tag, frac, kw in runs:
            rows[(tag, frac)] = serve(cfg, params, tot, tag, frac, **kw)
    counts, variants = read_launches(), read_variants()
    if (counts["K2"], counts["K3"], counts["K4"]) != (0, 0, 0):
        raise AssertionError(f"moe bf16: other kernels ran: {counts}")
    if variants["K1"] != {"mma": 3 * experts.calls, "fma": route.calls} \
            or experts.calls <= 0:
        raise AssertionError(f"moe bf16: K1 by kernel {variants['K1']}, not "
                             f"3 x {experts.calls} expert calls on the "
                             f"tensor cores and {route.calls} router calls "
                             "in f32")
    log(f"K1 launches on the moe path: {counts['K1']} == 3 x "
        f"{experts.calls} expert calls, all mma, + {route.calls} router "
        f"calls in f32 (by kernel {variants['K1']})")
    base = rows[("granular", 2.0)]["tokens"]
    for key, row in rows.items():
        if row["tokens"] != base:
            raise AssertionError(f"moe {key}: tokens differ from granular "
                                 "2.0x")
    log("moe tokens identical across granular 2.0x, 0.5x, 0.1x, monolithic "
        "2.0x, 0.5x and sync 0.1x: True")
    sync, ovl = rows[("granular-sync", 0.1)], rows[("granular", 0.1)]
    if (sync["streamed_bytes"], sync["streamed_bytes_by_dtype"]) != \
            (ovl["streamed_bytes"], ovl["streamed_bytes_by_dtype"]):
        raise AssertionError("moe overlap and sync streamed other bytes")
    if ovl["demanded_expert_bytes"] <= 0:
        raise AssertionError("moe 0.1x demanded no expert")
    log(f"moe overlap == sync at 0.1x: {ovl['streamed_bytes']} B streamed "
        "each")
    gap = teacher_forced_check(cfg, params, base,
                               rows[("granular", 2.0)]["prompts"])
    log(f"moe served tokens == plain monolithic greedy under teacher forcing "
        f"(max logit gap {gap:.4f})")
    out = {"rows": {f"{t} {f}x": {k: v for k, v in r.items()
                                  if k not in ("tokens", "prompts")}
                    for (t, f), r in rows.items()},
           "launches": counts["K1"], "variants": variants["K1"],
           "route_calls": route.calls, "expert_calls": experts.calls,
           "teacher_forced_gap": gap, "layers": cfg.n_layers,
           "weight_bytes": tot, "quant": {}}
    out["profile"] = profile_phase(cfg, params, db, system,
                                   int(tot[True] * 0.1), tag="moe 0.1x")
    for qtag, kw, kname in MOE_QUANT:
        t0 = time.perf_counter()
        qparams = moe_quantised(params, kw)
        qcfg = cfg.replace(**kw)
        qtot = totals(qcfg)
        log(f"moe {qtag}: experts quantised on the card in "
            f"{time.perf_counter() - t0:.1f} s; weight bytes {qtot[True]} B")
        qrows = {}
        reset_launches()
        with _CallCount(mlp, "_route") as route, \
                _CallCount(mlp, "expert_ffn") as experts, \
                _CallCount(mlp, "_dequant") as deq:
            for tag, frac, gkw in (("granular", 0.5, {}),
                                   ("monolithic", 0.5,
                                    dict(expert_granular=False)),
                                   ("granular", 0.1, {})):
                qrows[(tag, frac)] = serve(qcfg, qparams, qtot,
                                           f"{qtag} {tag}", frac, **gkw)
        counts, variants = read_launches(), read_variants()
        want = {"K1": route.calls, "K2": 0, "K3": 0, "K4": 0}
        want[kname] = 3 * experts.calls
        if counts != want or experts.calls <= 0 or deq.calls \
                or variants[kname] != {"mma": want[kname], "fma": 0} \
                or variants["K1"] != {"mma": 0, "fma": route.calls}:
            raise AssertionError(f"moe {qtag}: launches {counts} by kernel "
                                 f"{variants}, _dequant {deq.calls}; want "
                                 f"{want}, experts all mma, router f32")
        log(f"{kname} launches on the moe {qtag} path: {want[kname]} == 3 x "
            f"{experts.calls} expert calls (by kernel {variants[kname]}); "
            f"K1 {route.calls} router calls in f32; _dequant 0")
        qbase = qrows[("granular", 0.5)]["tokens"]
        for key, row in qrows.items():
            if row["tokens"] != qbase:
                raise AssertionError(f"moe {qtag} {key}: tokens differ from "
                                     "granular 0.5x")
        log(f"moe {qtag} tokens identical: granular 0.5x == monolithic 0.5x "
            "== granular 0.1x")
        qgap = teacher_forced_check(qcfg, qparams, qbase,
                                    qrows[("granular", 0.5)]["prompts"])
        log(f"moe {qtag} served tokens == plain monolithic greedy under "
            f"teacher forcing (max logit gap {qgap:.4f})")
        out["quant"][qtag] = {
            "rows": {f"{t} {f}x": {k: v for k, v in r.items()
                                   if k not in ("tokens", "prompts")}
                     for (t, f), r in qrows.items()},
            "kernel": kname, "launches": want[kname],
            "variants": variants[kname], "weight_bytes": qtot,
            "teacher_forced_gap": qgap}
        del qparams
        free_cuda()
    del params
    free_cuda()
    return out



def source_design(name):
    """The ``// Design`` block of ``kernels/csrc/<name>.cu``'s header
    comment as one line: what the measured kernel is, read from the source
    that was built, so the report cannot describe another version."""
    lines = (SRC / "repro_torch" / "kernels" / "csrc" / f"{name}.cu") \
        .read_text().splitlines()
    start = next(i for i, line in enumerate(lines)
                 if line.startswith("// Design"))
    head = lines[start][len("// Design"):].strip(" :()")
    block = [head + ":"] if head else []
    for line in lines[start + 1:]:
        if not line.startswith("//   "):
            break
        block.append(line[2:].strip())
    return " ".join(block).replace("- ", "", 1).replace(" - ", " ")


def kernel_designs():
    """What each kernel is, for the ``{"kernels": [...]}`` line."""
    return {
        "streamed_matmul": "bf16 (the main path): "
        + source_design("streamed_matmul_mma") + " f32: the CUDA-core "
        "FMA tile kernel of streamed_matmul.cu",
        "streamed_matmul_int8": "bf16 (the int8 main path): the Int8B "
        "format of streamed_matmul_mma.cu: "
        + source_design("streamed_matmul_mma") + " f32: the "
        "CUDA-core FMA tile kernel of streamed_matmul.cu (Int8W, codes "
        "dequantised to f32 in shared memory)",
        "streamed_matmul_int4": "bf16 (the int4 main path): the Int4B "
        "format of streamed_matmul_mma.cu: "
        + source_design("streamed_matmul_mma") + " f32: the "
        "CUDA-core FMA tile kernel of streamed_matmul.cu (Int4W, codes "
        "dequantised to f32 in shared memory)",
        "flash_attention": "bf16 (the VLM path): "
        + source_design("flash_attention_mma") + " f32 (and bf16 at "
        "unaligned shapes): the CUDA-core FMA kernel of "
        "flash_attention.cu"}


def kernel_entry(name, replaces, launches, max_err, shapes, headline,
                 source):
    """One kernel's entry of the ``{"kernels": [...]}`` line: the numbers
    at the ``headline`` shape (K1-K3: the up/gate projection at decode,
    M=4; K4: the 720p vision encoder's attention). ``source`` is the
    kernel that runs at that shape, ``replaces`` the TPU kernel's
    ``file:line`` under ``src/repro/kernels``."""
    shape = headline["shape"] if "shape" in headline else \
        [headline["M"], headline["K"], headline["N"]]
    return {"name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{source}.cu",
            "replaces": f"src/repro/kernels/{replaces}",
            "launches": launches, "max_abs_err": max_err,
            "ms": headline["ms"], "device_ms": headline.get("device_ms"),
            "plain_ms": headline["plain_ms"],
            "bound_ms": headline["bound_ms"],
            "bound_by": headline["bound_by"],
            "library_ms": headline["library_ms"],
            "design": kernel_designs()[name],
            "shape": shape, "shapes": shapes}


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found; run from a "
              "checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    t_start = time.perf_counter()
    card = card_line()
    log(card)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}")
    build_kernels()
    kern = kernel_phase()
    free_cuda()
    qkern = quant_kernel_phase()
    free_cuda()
    fkern = flash_kernel_phase()

    def headline(shapes):
        return next(s for s in shapes if s["M"] == 4 and s["K"] == 896)

    main = main_path()
    free_cuda()
    vision = vision_path()
    language = language_path()
    planning = vlm_planning(main["link_gbps"])
    free_cuda()
    moe = moe_path(main["link_gbps"])
    log(json.dumps({"main_path": main["rows"],
                    "quant_paths": main["quant"],
                    "link_gbps": main["link_gbps"],
                    "profile": main["profile"],
                    "vlm": {"vision": vision, "language": language,
                            "planning": planning,
                            "k4_block_q_bit_equal":
                                fkern["block_q_bit_equal"]},
                    "moe": moe,
                    "seconds": time.perf_counter() - t_start}))
    # kernel -> (the MoE run's tag, its results)
    moe_q = {kname: (qtag, moe["quant"][qtag])
             for qtag, _, kname in MOE_QUANT}
    kernels = [
        kernel_entry("streamed_matmul", "streamed_matmul.py:95",
                     main["launches"] + moe["launches"],
                     kern["max_abs_err"], kern["shapes"],
                     headline(kern["shapes"]),
                     source="streamed_matmul_mma"),
        kernel_entry("streamed_matmul_int8", "streamed_matmul.py:212",
                     main["quant"]["int8"]["launches"]
                     + moe_q["K2"][1]["launches"],
                     qkern["int8"]["max_abs_err"], qkern["int8"]["shapes"],
                     headline(qkern["int8"]["shapes"]),
                     source="streamed_matmul_mma"),
        kernel_entry("streamed_matmul_int4", "streamed_matmul.py:289",
                     main["quant"]["int4"]["launches"]
                     + moe_q["K3"][1]["launches"],
                     qkern["int4"]["max_abs_err"], qkern["int4"]["shapes"],
                     headline(qkern["int4"]["shapes"]),
                     source="streamed_matmul_mma"),
        kernel_entry("flash_attention", "flash_attention.py:104",
                     vision["launches"] + language["launches"],
                     fkern["max_abs_err"], fkern["shapes"],
                     next(s for s in fkern["shapes"] if s["tag"] == "vision"),
                     source="flash_attention_mma")]
    kernels[0].update({"launches_by_path": {
                           "qwen2-0.5b": main["launches"],
                           MOE_ARCH: moe["launches"]},
                       "launches_by_variant": {
                           "qwen2-0.5b": main["variants"]["K1"],
                           MOE_ARCH: moe["variants"]},
                       "check_launches_by_variant":
                           kern["variant_launches"]})
    for entry, mode, kname in zip(kernels[1:3], QUANT_MODES, ("K2", "K3")):
        entry.update({
            "launches_by_path": {
                f"qwen2-0.5b {mode}": main["quant"][mode]["launches"],
                f"{MOE_ARCH} {moe_q[kname][0]}": moe_q[kname][1]["launches"]},
            "launches_by_variant": main["quant"][mode]["variants"],
            "check_launches_by_variant": qkern[mode]["variant_launches"],
            "round_excess": qkern[mode]["round_excess"],
            "planted_faults": qkern[mode]["faults"]})
    kernels[-1].update({
        "launches_by_path": {
            "vision_720p_encode": vision["launches"],
            f"language_forward_T{language['T']}": language["launches"]},
        "launches_by_variant": {
            "vision_720p_encode": vision["variant_launches"],
            f"language_forward_T{language['T']}":
                language["variant_launches"]},
        "checked_shapes": fkern["checked"],
        "block_q_bit_equal": fkern["block_q_bit_equal"],
        "block_q_bit_equal_bf16": fkern["block_q_bit_equal_bf16"]})
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
