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
   ``torch.matmul`` on the dequantised bf16 weight (not the same
   function); K3's ``library_ms`` is ``torch._weight_int4pack_mm``
   (tinygemm: the same function up to bf16's rounding of its scales and
   zeros, held to K3's plain version within 2e-2 and timed over the same
   copies; null, with the reason, where this torch has no CUDA kernel for
   it). K2's is null: ``torch._weight_int8pack_mm`` takes one scale per
   column, K2 one per 512-row group, so it computes K2's function only
   where K <= 512. Then K4
   (flash_attention) against its plain version over the sweep of
   tests/test_kernels.py, at the VLM path's vision (720p encoder) and
   language (qwen2-vl-7b at 4096 tokens) shapes and at zamba2-7b's (head
   dim 112) and musicgen-medium's (64) at 4096 tokens, ragged causal
   lengths (at head dims 128 and 112) and Tq != Tk, bf16 and f32 (the vision and language shapes in f32 as
   well), bf16 on the tensor-core kernel and f32 on the CUDA-core one
   (per-variant launch counts); bf16 also within a limit set by the
   tensor-core kernel's rounding of p and of its output, which the
   kernel run without its last kv tile (a planted fault, at the vision,
   language and ragged shapes) must exceed; its results across
   ``block_q`` (64, 128 and the reference's 663) at the vision shape in
   f32 and in bf16; its
   times (events and device time), the plain version's and
   ``scaled_dot_product_attention``'s (the yardstick only). Then K4's
   backward (``flash_attention_bwd.cu``) against its plain version at
   qwen2-0.5b's (1, 14/2, 4096, 64) causal, the language and vision
   shapes, zamba2's and musicgen's head dims and a ragged 2081, bf16 and
   f32, each within a limit set by its rounding (the output's rounding
   and its f32 sums) that the kernel fed inputs without its last key tile
   (dq) or its last query block (dk, dv) must exceed; the forward asked
   for its lse ``torch.equal`` to the forward without it; its times at
   phase 17's (4, 14/2, 4096, 64) and the language shape beside its bound,
   the plain version's and SDPA's backward (the yardstick only);
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
   ``_dequant``, and the same plain teacher-forced check; int8 experts
   also granular at 0.5x with every prefill forced to tier 32 and to 64
   (whether the tokens are identical is printed). One more bf16
   run serves granular at 0.5x with paged KV: tokens equal the stacked
   runs', ledger (pages as "kv") and peak gated;
12. paged KV (phase 3's model, weights and wave, at 0.1x,
   ``kv_layout="paged"``): with the planner's pool, and with 64 pages
   (under the 480 live blocks, over one layer's 20) pipelined and sync,
   tokens equal phase 3's stacked tokens; on the 64-page runs evictions
   and restores both happen (printed per decode step); a staggered wave
   of 6 requests at ``max_batch=4`` and a wave of 4 prompts sharing a
   48-token prefix, each against stacked serving of the same requests,
   the prefix counters equal to what the prompts imply; every run's
   ledger (streamed == static plan + demanded pages, pages as "kv") and
   peak (the page pools in place of the stacked cache) gated; K1's
   launches, all on the tensor cores; ``Session.estimates(64,
   prefix_hit_frac=0.75)`` printed;
13. speculative decoding: qwen3-14b at its published widths (d=5120,
   40/8 heads, hd=128, qk-norm, f=17408, vocab 151936, untied) and 10
   of its 40 layers, seeded bf16 weights drawn on the card; the
   executor's ``_run_verify`` over 4 positions ``torch.equal`` to 4
   ``_run_decode`` calls (logits and caches), stacked and paged; served
   with qwen2-0.5b (phase 3's weights) as its draft at k = 3 at 0.5x,
   stacked and paged, and with itself as its draft at 1.8x: tokens equal
   plain greedy serving at the same budget, the draft streams nothing,
   every verify pass's ledger exact, drafted == accepted + rolled back,
   peak within the bound with the draft's pins, cache and head counted,
   self-speculation's acceptance above 0.6; tok/s and TTFT of each
   speculative run and its plain twin printed; K1's launches, all on the
   tensor cores;
14. faults and the degradation ladder, each faulted run under a
   wall-clock guard, its tokens against its undisturbed twin, its ledger
   exact (under the plan of each pass's time) and its peak gated (after
   a rung, under the new plan's bound; the card's reserved bytes printed
   before and after each rung): qwen2-0.5b with phase 3's weights at 0.1x
   under an empty plan (tokens, ledger and K1 launches equal phase 3's),
   ``prefetch.copy`` fail x2 (retried), fail x4 on one sub-layer (one sync
   fallback), delay, ``prefetch.worker`` crash (the watchdog's ``sync``
   rung), ``alloc.device`` at a decode pass (``tier_down``) and
   ``serving.request`` on rid 2 (it fails alone); phase 12's 64-page
   paged run under ``alloc.host`` (the pool consistent after); phase 11's
   qwen30b-a3b granular at 0.1x under ``demand.copy`` fail x20,
   ``demand.timeout`` and ``demand.worker`` crash (tokens and ledger equal
   phase 11's) and ``alloc.device`` (``expert_shrink``); phase 13's
   qwen3-14b speculative run at 0.5x under ``alloc.device`` at a verify
   pass (``spec_off``: tokens equal plain greedy, the draft gone);
15. the gateway: qwen2-0.5b at 0.1x behind ``Session.gateway(max_batch=4,
   max_queue=16)`` through ``InprocClient``, 8 streamed requests of 64
   prompt tokens and 16 new ones, 10 ms apart, with queue-aware tier
   picks on and off: SSE tokens equal a direct serve of the same
   requests, the first chunk before the first completion, the broker
   ledger reconciled, unary equal to stream; TTFT p50 / p99 and aggregate
   tok/s against the direct batcher printed; a ``gateway.pump`` fault
   fails the active tickets only; ``/admin/rebudget`` 0.1x -> 0.5x
   mid-wave (moved bytes equal ``Schedule.diff``); a client disconnecting
   mid-stream from the 64-page paged session frees its pages; ``/healthz``
   reports the rung after an ``alloc.device``;
16. the hybrid, SSM and audio families, each drawn whole at its published
   widths in bf16 on the card and served through ``Model.prefill`` /
   ``decode_step``: the SSD scan against the sequential f64 recurrence at
   zamba2's and xLSTM's layer shapes; per model a wave of 4 prompts of 64
   tokens (frames) with 16 greedy tokens (prefill s, decode tok/s, the
   peak gated against weights + cache + ``family_transient_bytes``, the
   tokens under teacher forcing against the cache-less forward); zamba2-7b
   with one 3840-token prompt and 256 decode steps and musicgen-medium
   with 4080 frames and 16, each against its cache-less forward at 4096
   tokens through K4 (13 and 48 launches, tensor cores, each within the
   bf16-p limit); zamba2 (``TF_DRIFT_ARCHS``) also in f32, where its
   tokens and its K4 forward against the plain attention's are gated;
   each model's planning-only session (its executor raises); a probe of
   which prefill ops give rows whose bits follow the chunk's row count;
17. training: (a) ``repro_torch.launch.train.main`` on qwen2-0.5b at its
   published widths and depth, B = 4, T = 4096 (every layer's attention
   through K4 forward and backward), remat full, 8 steps with a
   checkpoint every 3 and a fault injected at step 5: finite and falling
   losses, one restart from the step-3 checkpoint whose replayed losses
   equal the first run's, K4's forward and backward launches counted
   (remat recomputes each forward), the peak against a bound worked out
   from the shapes, step s and train tokens/s; (b) at B = 1, remat none,
   the grads through K4 against the same step with the plain attention:
   bf16 as close to the f32 gradient as the plain one's, K4's peak at
   least 20 GB under the plain one's, and f32 over 6 layers within 1e-4;
   (c) microbatches 2 against 1 on a 4 x 4096 batch; (d) one remat-none
   step of xlstm-125m, musicgen-medium (4096 frames), zamba2-7b (12 of 81
   layers), qwen2-vl-7b (4 of 28 layers, 1024 vision embeddings, 3072
   text tokens, ``loss_mask``) and qwen30b-a3b (2 of 48 layers, T = 512,
   K1's launches counted), grads finite, zamba2 and qwen2-vl-7b against
   the plain attention as in (b);
18. counts (``repro_torch.launch.counting``): (a) phase 17's train step
   (qwen2-0.5b, B = 4, T = 4096, remat full, K4 forward and backward on
   every layer), (b) prefill_32k's length at batch 1 through the
   cache-less forward (K4 on every layer) and decode_32k's cache at the
   largest batch up to 128 whose counted peak fits 60 GB, each counted on
   fake tensors and on the card: flops and bytes equal as integers, the
   K4 and K4-backward units equal to the wrappers' launches, the card's
   temporary bytes (``max_memory_allocated`` less what was allocated
   before) within the limit of the count (``CUBLAS_WORKSPACE``), and a
   planted fault (the largest storage alive at the counted peak dropped)
   outside it; (c) each step's median time and achieved TFLOP/s as a
   share of the bf16 peak (not gated); (d) the fake-tensor records of
   qwen2-0.5b's three cells and xlstm-125m's four through
   ``python -m repro_torch.launch.dryrun``, each process under a wall
   guard, run beside (a)-(c);
19. the examples' twins (``examples/*_torch.py``), each ``main(argv)``
   called in process under a wall guard, its kernels counted from 0:
   ``serve_vram_budget_torch`` at qwen2-0.5b's published config (tokens
   identical across 2.0x, 0.5x and 0.1x and across the live re-budget,
   streamed bytes at 0.1x, each session's peak within ``memory_bound``,
   K1 on the tensor cores only) and at its default, qwen30b-a3b's smoke
   config (the same token gates); ``quickstart_torch`` at qwen2-0.5b's
   published config (tokens identical across its re-budget);
   ``serve_http_torch`` at qwen2-0.5b's published config on a socket
   (stream == unary, the in-flight stream unchanged across
   ``/admin/rebudget``, ``/metrics`` completed 4); ``vlm_budget_torch``
   (the f32 encoder's flash encodes against the plain one within the f32
   K4 atol, 28 K4 launches on the CUDA-core kernel, the grid and plans
   equal to a CPU run's); ``train_lm_torch`` with the 100m preset at
   T = 4096, B = 2, 30 steps and a fault at step 25 (the restart from
   step 20, the replayed losses bit-equal, the loss falling, K4 forward
   and backward once a layer per step pass, on the tensor cores).
20. decode graphs (``PipelinedExecutor.decode_fused``,
   ``decode_graph_check``): on a resident qwen3-14b plan (published
   widths, 2 layers) and a resident Nemotron-H hybrid (``M*-``), 16
   graphed fused passes at the card's own tier pick, then 100 with each
   count of active slots at one of the first four tiers of the table,
   against as many eager ones on a copy of the cache, with changing
   active masks and positions: logits and tokens ``torch.equal`` and the
   caches (KV, conv and SSM state) equal after, one recording per tier
   and cache and none after, one more after a rebind, K1 launched by its
   wrapper as often on a graphed pass as on an eager one; a graphed and
   an eager step's host ms. Then ``concurrent_cublas_check``: another
   thread's cuBLAS matmuls across 4 recordings stay ``torch.equal``.
   To run it alone: import ``chip_smoke`` with ``src`` on the path,
   ``build_kernels()``, ``decode_graph_path()`` (~1 min).

It needs one CUDA card and exits non-zero without one, or when run from a
directory that does not hold the repository's ``src/repro_torch``.
"""
from __future__ import annotations

import asyncio
import functools
import gc
import json
import math
import subprocess
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# the H100's peak rates and each kernel's bound: repro_torch.launch.counting
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
            "K4 (fma)": fa.LIBRARY, "K4 bf16 (mma)": fa.LIBRARY_MMA,
            "K4 backward (fma)": fa.LIBRARY_BWD,
            "K4 backward bf16 (mma)": fa.LIBRARY_BWD_MMA}
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


def bound(M, K, N, dtype_bytes, w_bytes=None):
    """Least ms for (M,K)@(K,N) in bf16 and what sets it: the hand count of
    K1-K3 in ``repro_torch.launch.counting`` (``matmul_work``: 2MNK, and x,
    the weight and y moved once; ``w_bytes`` replaces the weight's
    K*N*dtype_bytes for quantised codes, scales and zeros) over the H100's
    rates (``bound_ms``)."""
    from repro_torch.launch import counting
    return counting.bound_ms(
        counting.matmul_work(M, K, N, dtype_bytes, w_bytes),
        counting.PEAK_BF16_FLOPS)


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
    # the main path's shapes (qwen2-0.5b's FFN, qwen30b-a3b's experts,
    # then qwen3-14b's FFN at decode, M=4, and in the verify window of
    # 4 x (k+1), M=16), bf16, timed
    for (K, N, Ms) in ((896, 4864, (1, 4, 64, 256)),
                       (4864, 896, (1, 4, 64, 256)),
                       (2048, 768, (4, 64)), (768, 2048, (4, 64)),
                       (5120, 17408, (4, 16)), (17408, 5120, (4, 16))):
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
            b_ms, b_by = bound(M, K, N, 2)
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
                   (768, 2048), (2048, 128), (5120, 17408), (17408, 5120)):
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
    for (M, K, N) in ((4, 4864, 896), (64, 4864, 896), (300, 896, 4864),
                      (16, 17408, 5120)):
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


# K3's yardstick, torch._weight_int4pack_mm (tinygemm), computes
# x @ w with w = (q - 8) s' + z' per group of K rows and column, s' and z'
# in x's dtype. K3's w = (q - z) s is that with s' = s and z' = (8 - z) s,
# up to bf16's rounding of s' and z'. The op takes groups of 32, 64, 128
# or 256 rows, N a multiple of 8 and K a multiple of 16 x innerKTiles
# (2, 4 or 8: the k16 tiles its converted layout interleaves); 8 here, as
# every shape timed below has K a multiple of 128.
INT4PACK_INNER_K_TILES = 8
INT4PACK_GROUPS = (32, 64, 128, 256)


def int4pack_operands(packed, scales, zeros):
    """K3's operands (``packed (K/2, N)`` uint8 with the even row in the
    low nibble, ``scales (G, N)`` fp16, ``zeros (G, N)`` uint8) as
    ``torch._weight_int4pack_mm``'s, before its weight conversion: (the
    codes as ``(N, K/2)`` uint8 with the even k in the high nibble, the
    layout ``torch._convert_weight_to_int4pack`` takes; ``qScaleAndZeros
    (G, N, 2)`` bf16 holding s and (8 - z) s; the group's rows)."""
    import torch
    from repro_torch.kernels import streamed_matmul as sm
    q = sm.unpack_int4(packed).t()
    codes = (q[:, 0::2] << 4) | q[:, 1::2]
    s = scales.to(torch.float32)
    sz = torch.stack([s, (8.0 - zeros.to(torch.float32)) * s], dim=-1)
    g = -(-2 * packed.shape[0] // scales.shape[0])
    return codes.contiguous(), sz.to(torch.bfloat16).contiguous(), g


def int4pack_unfit(K, N, g):
    """Why ``torch._weight_int4pack_mm`` cannot take a (K, N) weight in
    groups of g rows; None where it can."""
    if g not in INT4PACK_GROUPS:
        return f"groups of {g} rows, not one of {INT4PACK_GROUPS}"
    if K % (16 * INT4PACK_INNER_K_TILES) or N % 8:
        return (f"K = {K} not a multiple of {16 * INT4PACK_INNER_K_TILES} "
                f"or N = {N} not of 8")
    return None


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


def library_yardstick(x, lib_qs, want, g):
    """``torch._weight_int4pack_mm`` on ``x`` over the converted copies
    ``lib_qs`` ((weight, qScaleAndZeros) pairs): its max |err| against K3's
    plain version ``want`` and, within 2e-2, its time by events and on the
    device. A disagreement is reported in ``library_note`` and leaves the
    times null: they would be another function's (the yardstick gates
    nothing in the port)."""
    import torch

    def op(x, wp, sz):
        return torch._weight_int4pack_mm(x, wp, g, sz)
    res = {"library_ms": None, "library_device_ms": None,
           "library_max_abs_err": None, "library_note": None}
    try:
        res["library_max_abs_err"] = check_close(
            "torch._weight_int4pack_mm", op(x, *lib_qs[0]), want, "bfloat16")
    except AssertionError as e:
        res["library_note"] = f"disagrees with K3's plain version: {e}"
        log(f"K3's yardstick at ({x.shape[0]},{x.shape[1]}): "
            f"{res['library_note']}; its time is not kept")
        return res
    args = [(x,) + qq for qq in lib_qs]
    res["library_ms"] = time_ms(op, args)
    res["library_device_ms"] = device_ms(op, args, None)
    return res


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
    # K3's yardstick where this torch has its CUDA kernel; K2 has none
    lib4 = {"op": "torch._weight_int4pack_mm",
            "inner_k_tiles": INT4PACK_INNER_K_TILES,
            "cuda_kernel": torch._C._dispatch_has_kernel_for_dispatch_key(
                "aten::_weight_int4pack_mm", "CUDA"), "reason": None}
    if not lib4["cuda_kernel"]:
        lib4["reason"] = (f"torch {torch.__version__} has no CUDA kernel "
                          "for aten::_weight_int4pack_mm")
        log(f"K3's yardstick: {lib4['reason']}; K3's library_ms is null")
    out["int4"]["library"] = lib4
    out["int8"]["library"] = {
        "op": None, "reason": "torch._weight_int8pack_mm takes one scale "
        "per column; K2 keeps one per 512-row group, so the op computes "
        "K2's function only where K <= 512"}
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
            # the yardstick's operands, converted once for every copy
            lib_qs, lib_why = [], out[mode]["library"]["reason"]
            if mode == "int4" and lib_why is None:
                g = -(-K // q[1].shape[0])
                lib_why = int4pack_unfit(K, N, g)
                if lib_why is None:
                    lib_qs = [(torch._convert_weight_to_int4pack(
                        c, INT4PACK_INNER_K_TILES), sz) for c, sz, _ in
                        (int4pack_operands(*qq) for qq in qs)]
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
                b_ms, b_by = bound(M, K, N, 2, w_bytes=w_bytes)
                lib = {"library_ms": None, "library_note": lib_why}
                if lib_qs:
                    lib = library_yardstick(x, lib_qs, plain[mode](x, *q), g)
                out[mode]["shapes"].append(
                    {"M": M, "K": K, "N": N, "dtype": "bfloat16",
                     "w_bytes": w_bytes, "max_abs_err": e,
                     "round_excess": ex, "ms": ms, "device_ms": dev_ms,
                     "plain_ms": plain_ms, **lib,
                     "bf16_matmul_context_ms": ctx_ms, "bound_ms": b_ms,
                     "bound_by": b_by, "split": list(sm.split_plan(K, N))})
                if lib["library_ms"] is not None:
                    lib_err = lib["library_max_abs_err"]
                    lib_txt = (f"; {lib4['op']} {lib['library_ms']:.4f} ms "
                               f"(device {fmt_ms(lib['library_device_ms'])}"
                               f"), max |err| {lib_err:.3e} against the "
                               "plain version (within rtol = atol = 2e-2)")
                else:
                    lib_txt = f"; no library time: {lib['library_note']}"
                log(f"{mode} ({M},{K})@({K},{N}) bf16 x: kernel {ms:.4f} "
                    f"ms (device {fmt_ms(dev_ms)}), plain {plain_ms:.4f} "
                    f"ms, bound {b_ms:.4f} ms ({b_by}, {w_bytes} weight "
                    f"bytes), max |err| {e:.3e}, {ex:.3f}x the rounding "
                    f"limit{lib_txt}; context, not the same function: "
                    f"torch.matmul on the dequantised bf16 weight "
                    f"{ctx_ms:.4f} ms")
            del qs, wds, wd, lib_qs
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
ZAMBA2_SHAPE = (1, 32, 32, 4096, 4096, 112)         # zamba2-7b's shared block
MUSICGEN_SHAPE = (1, 24, 24, 4096, 4096, 64)        # musicgen-medium
VISION_Q_CHUNK = 663        # the reference's Q-chunk at N = 4641
KNOB_TOL = 2e-5             # tests/test_kernels.py::test_flash_q_chunk_knob


def flash_bound(shape, causal, dtype_bytes):
    """Least ms for one bf16 attention call: ``counting.flash_work`` (q, k,
    v read once and o written once, or 4 * hd operations per visible
    (query, key) pair, the causal pairs counted exactly) over the H100's
    rates."""
    from repro_torch.launch import counting
    return counting.bound_ms(counting.flash_work(shape, causal, dtype_bytes),
                             counting.PEAK_BF16_FLOPS)


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
                                  ((1, 32, 32, 2081, 2081, 112), True, 1024,
                                   1024),
                                  ((1, 8, 8, 300, 1000, 112), True, 64, 64),
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
            ("language", LANGUAGE_SHAPE, True, 1024, 1024),
            ("zamba2", ZAMBA2_SHAPE, True, 1024, 1024),
            ("musicgen", MUSICGEN_SHAPE, True, 1024, 1024)):
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
        b_ms, b_by = flash_bound(shape, causal, 2)
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


# ------------------------------------------------------- phase 2: K4 backward
# (tag, (B, H, KV, Tq, Tk, hd), causal): qwen2-0.5b's training shape at one
# sequence, the VLM's language and vision shapes, zamba2's and musicgen's
# head dims, a ragged length no tile divides
BWD_SHAPES = (("qwen2-0.5b", (1, 14, 2, 4096, 4096, 64), True),
              ("language", LANGUAGE_SHAPE, True),
              ("vision", VISION_SHAPE, False),
              ("zamba2", ZAMBA2_SHAPE, True),
              ("musicgen", MUSICGEN_SHAPE, True),
              ("ragged", (1, 28, 4, 2081, 2081, 128), True))
# timed: phase 17's headline attention (qwen2-0.5b, B = 4) and the language
# shape, bf16
BWD_TIMED = (("qwen2-0.5b train", (4, 14, 2, 4096, 4096, 64), True),
             ("language", LANGUAGE_SHAPE, True))
# The backward kernels are held, in bf16 and f32, to a limit set by their
# rounding against the plain version's f32 result on the same inputs (q,
# k, v, the forward's lse, dO) before its cast. The CUDA-core kernel
# (f32, and bf16 at unaligned shapes) sums exact products in f32: the output's
# rounding, 2^-8 |ref| in bf16 (2^-23 in f32: round to nearest is half of
# that), plus BWD_F32 times the element's absolute sum A (the same sums
# over |terms|: A_dv = |p|^T |dO|, A_dq = scale |ds'| |k|, A_dk = scale
# |ds'|^T |q| with |ds'| = p (|dO| |v|^T + |D|), D = rowsum(p dP)), for
# the f32 sums of up to
# a few thousand terms in another order (their error grows as sqrt(n)
# 2^-24 A, about 4e-6 A at n = 4096) and the forward's lse (ex2.approx on
# the tensor cores: p to about 1e-6). A sound kernel's excess (max error
# / limit) stays at most 1; the kernel fed inputs that drop its last key
# tile from dq, or its last query block from dk and dv (planted faults),
# must go above it.
BWD_F32 = 2.0 ** -16
BWD_ROUND = {"bfloat16": 2.0 ** -8, "float32": 2.0 ** -23}
# The tensor-core kernel (bf16) also rounds its operands: p to bf16 before
# dv = p^T dO, and ds to bf16 before dq = scale ds k and dk = scale ds^T q
# (unit roundoff 2^-8 each, as the plain bf16 attention's autograd rounds
# them), with every sum and D in f32. An element's error from them is
# sum_t d_t x_t over its terms x_t (p dO for dv, scale ds k for dq, scale
# ds q for dk), |d_t| <= 2^-8, independent: roundings of scale 2^-8 R with
# R = sqrt(sum_t x_t^2), i.e. sqrt(sum_i p^2 dO^2) (dv), scale
# sqrt(sum_j ds^2 k^2) (dq), scale sqrt(sum_i ds^2 q^2) (dk). Its limit adds
# BWD_MMA_SCALES times that scale to the one above, as the forward's
# bf16-p limit does (P_ROUND_SCALES); 8 bounds it outright for up to 64
# terms, by Cauchy-Schwarz, and is about 14 standard deviations of it
# beyond. A planted fault drops a 64-key tile (or query block) of terms,
# about 8 times their typical size, so it still exceeds the limit where
# R sums a few thousand terms (2^-8 x 8 x sqrt(4096) = 2 terms' size).
BWD_MMA_SCALES = 8.0
# the planted faults: (tag, shape, causal)
BWD_FAULTS = (BWD_SHAPES[0], BWD_SHAPES[2], BWD_SHAPES[5])
# the backward's kernels as torch.profiler names them: on the tensor cores
# (bf16) and on the CUDA cores (f32; the yardstick of the timed shapes)
BWD_MMA_NAMES = ("::dkdv_mma_kernel<", "::rows_mma_kernel<")
BWD_FMA_NAMES = ("::dkdv_kernel<", "::rows_kernel<")


def flash_bwd_bound(shape, causal, dtype_bytes):
    """Least ms for K4's backward in bf16: ``counting.flash_bwd_work`` (2.5x
    the forward's operations, or q, k, v, dO, lse read once and dq, dk, dv
    written once) over the H100's rates."""
    from repro_torch.launch import counting
    return counting.bound_ms(
        counting.flash_bwd_work(shape, causal, dtype_bytes),
        counting.PEAK_BF16_FLOPS)


def attention_bwd_f32(q, k, v, dout, lse, causal, with_rss=False):
    """The plain backward (``kernels/ref.py::flash_attention_bwd_ref``) in
    f32 without its final cast, and each gradient's absolute sum A (see
    ``BWD_F32``): ((dq, dk, dv), (A_dq, A_dk, A_dv)); ``with_rss`` adds
    the root-sum-square scale R of the terms the tensor-core kernel
    rounds (see ``BWD_MMA_SCALES``), (R_dq, R_dk, R_dv)."""
    import torch
    from repro_torch.kernels.ref import NEG_INF
    B, H, Tq, hd = q.shape
    KV, Tk = k.shape[1], k.shape[2]
    G = H // KV
    f = torch.float32
    qg = q.reshape(B, KV, G, Tq, hd).float()
    kf, vf = k.float(), v.float()
    s = torch.einsum("bkgtd,bksd->bkgts", qg, kf) * hd ** -0.5
    if causal:
        mask = torch.arange(Tk, device=q.device)[None, :] \
            <= torch.arange(Tq, device=q.device)[:, None]
        s = torch.where(mask, s, NEG_INF)
    p = torch.exp(s - lse.reshape(B, KV, G, Tq, 1).to(f))
    del s
    dog = dout.reshape(B, KV, G, Tq, hd).float()
    dv = torch.einsum("bkgts,bkgtd->bksd", p, dog)
    a_dv = torch.einsum("bkgts,bkgtd->bksd", p, dog.abs())
    ds = torch.einsum("bkgtd,bksd->bkgts", dog, vf)
    delta = (p * ds).sum(-1, keepdim=True)
    ds = p * (ds - delta)
    dq = torch.einsum("bkgts,bksd->bkgtd", ds, kf) * hd ** -0.5
    dk = torch.einsum("bkgts,bkgtd->bksd", ds, qg) * hd ** -0.5
    rss = None
    if with_rss:
        ds.square_()
        r_dq = torch.einsum("bkgts,bksd->bkgtd", ds, kf.square()).sqrt_() \
            * hd ** -0.5
        r_dk = torch.einsum("bkgts,bkgtd->bksd", ds, qg.square()).sqrt_() \
            * hd ** -0.5
        r_dv = torch.einsum("bkgts,bkgtd->bksd", p.square(),
                            dog.square()).sqrt_()
        rss = (r_dq.reshape(B, H, Tq, hd), r_dk, r_dv)
    del ds
    ds_abs = p * (torch.einsum("bkgtd,bksd->bkgts", dog.abs(), vf.abs())
                  + delta.abs())
    del p
    a_dq = torch.einsum("bkgts,bksd->bkgtd", ds_abs, kf.abs()) * hd ** -0.5
    a_dk = torch.einsum("bkgts,bkgtd->bksd", ds_abs, qg.abs()) * hd ** -0.5
    del ds_abs
    out = ((dq.reshape(B, H, Tq, hd), dk, dv),
           (a_dq.reshape(B, H, Tq, hd), a_dk, a_dv))
    return out + (rss,) if with_rss else out


def bwd_excess(out, ref, absum, dtype, rss=None):
    """Max over elements of |out - ref| / the backward's rounding limit:
    the CUDA-core kernel's, or with ``rss`` (R, ``attention_bwd_f32``) the
    tensor-core kernel's."""
    lim = BWD_ROUND[dtype] * ref.abs() + BWD_F32 * absum + 1e-30
    if rss is not None:
        lim = lim + BWD_MMA_SCALES * BWD_ROUND["bfloat16"] * rss
    return ((out.float() - ref).abs() / lim).max().item()


def _bwd_inputs(gen, shape, causal, dtype):
    """q, k, v, dO on the card and the lse of K4's forward (asked for),
    whose output is checked ``torch.equal`` to the forward without it."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    B, H, KV, Tq, Tk, hd = shape
    (q, k, v), = _qkv(gen, shape, dtype)
    dout = torch.randn((B, H, Tq, hd), generator=gen, device="cuda") \
        .to(dtype)
    o = torch.empty_like(q)
    lse = torch.empty((B, H, Tq), dtype=torch.float32, device="cuda")
    fa.launch(q, k, v, o, causal=causal, block_q=1024, block_k=1024,
              lse=lse)
    plain = fa.flash_attention(q, k, v, causal=causal, block_q=1024,
                               block_k=1024)
    if not torch.equal(o, plain):
        raise AssertionError(f"K4 forward with lse at {shape} {dtype} is "
                             "not torch.equal to the forward without it")
    del o, plain
    return q, k, v, dout, lse


def flash_bwd_phase():
    """K4's backward against its plain version on the card: every shape
    of ``BWD_SHAPES`` in bf16 on the tensor-core kernel within its
    rounding limit (two launches ``torch.equal``) and in f32 on the
    CUDA-core kernel within its own, unaligned bf16 calls on the CUDA
    cores, the planted faults above the tensor-core limit, the forward
    with lse bit-equal to the serving forward, and the times at
    ``BWD_TIMED`` beside the CUDA-core kernel's on the same inputs."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.ref import flash_attention_bwd_ref
    import torch.nn.functional as F
    gen = torch.Generator(device="cuda").manual_seed(2025)
    before = fa.flash_attention_backward.launches
    reset_variants()
    counts = fa.flash_attention_backward.variant_launches
    checked, faults, timed = [], [], []
    max_err = 0.0

    def check(tag, shape, causal, dtype, inputs, variant):
        """One backward call through the wrapper: the kernel it took
        (``variant``), its excess over that kernel's rounding limit, finite
        grads; returns (excess, max |err|, grads, refs, abss, rss), rss all
        None for the CUDA-core kernel."""
        dname = str(dtype).split(".")[-1]
        n0 = dict(counts)
        grads = fa.flash_attention_backward(*inputs, causal=causal)
        if counts[variant] != n0[variant] + 1:
            raise AssertionError(f"K4 backward {tag} {shape} {dname} did not "
                                 f"take the {variant} kernel: {counts}")
        mma = variant == "mma"
        refs, abss, *rss = attention_bwd_f32(*inputs, causal, with_rss=mma)
        rss = rss[0] if mma else (None,) * 3
        x = max(bwd_excess(g, r, a, dname, s)
                for g, r, a, s in zip(grads, refs, abss, rss))
        err = max((g.float() - r).abs().max().item()
                  for g, r in zip(grads, refs))
        if not all(bool(torch.isfinite(g).all()) for g in grads):
            raise AssertionError(f"K4 backward {tag} {shape} {dname}: "
                                 "non-finite gradient")
        if not x <= 1.0:
            raise AssertionError(f"K4 backward {tag} {shape} {dname} "
                                 f"({variant}): {x:.3f}x the rounding limit")
        return x, err, grads, refs, abss, rss

    for tag, shape, causal in BWD_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            dname = str(dtype).split(".")[-1]
            variant = "mma" if dtype == torch.bfloat16 else "fma"
            inputs = _bwd_inputs(gen, shape, causal, dtype)
            x, err, grads, refs, abss, rss = check(tag, shape, causal, dtype,
                                                   inputs, variant)
            entry = {"tag": tag, "shape": list(shape), "causal": causal,
                     "dtype": dname, "kernel": variant, "max_abs_err": err,
                     "round_excess": x}
            msg = ""
            if variant == "mma":   # no atomics: bits fixed by the launch
                again = fa.flash_attention_backward(*inputs, causal=causal)
                entry["relaunch_equal"] = all(
                    torch.equal(a, b) for a, b in zip(grads, again))
                if not entry["relaunch_equal"]:
                    raise AssertionError(f"K4 backward {tag} {shape}: two "
                                         "launches differ")
                msg = "; a second launch torch.equal"
                del again
            max_err = max(max_err, err)
            checked.append(entry)
            log(f"K4 backward {tag} {shape} causal={causal} {dname}: kernel "
                f"{variant}, {x:.3f}x its rounding limit, max |err| "
                f"{err:.3e}{msg}; forward with lse torch.equal to the "
                "forward without it")
            if variant == "mma" and (tag, shape, causal) in BWD_FAULTS:
                faults += bwd_planted_faults(tag, shape, causal, *inputs,
                                             refs, abss, rss)
            del inputs, grads, refs, abss, rss
            free_cuda()
    # bf16 that the tensor-core kernel does not take: a head dim that is
    # not a multiple of 8, an output gradient 2 bytes off 16-byte alignment
    for tag, shape in (("hd 36", (1, 8, 2, 300, 300, 36)),
                       ("dO offset", (1, 14, 2, 1000, 1000, 64))):
        q, k, v, dout, lse = _bwd_inputs(gen, shape, True, torch.bfloat16)
        if tag == "dO offset":
            flat = torch.empty(dout.numel() + 1, dtype=dout.dtype,
                               device="cuda")
            dout = flat[1:].view(dout.shape).copy_(dout)
        x, err, *_ = check(tag, shape, True, torch.bfloat16,
                           (q, k, v, dout, lse), "fma")
        checked.append({"tag": tag, "shape": list(shape), "causal": True,
                        "dtype": "bfloat16", "kernel": "fma",
                        "max_abs_err": err, "round_excess": x})
        log(f"K4 backward {tag} {shape} causal=True bfloat16 (not aligned "
            f"for the tensor cores): kernel fma, {x:.3f}x its rounding "
            f"limit, max |err| {err:.3e}")
        del q, k, v, dout, lse
        free_cuda()
    n = len(BWD_SHAPES)
    want = {"mma": 2 * n + 2 * len(BWD_FAULTS), "fma": n + 2}
    n_calls = fa.flash_attention_backward.launches - before
    if counts != want or n_calls != sum(want.values()):
        raise AssertionError(f"K4 backward counted {n_calls} launches by "
                             f"kernel {counts}, want {want}")
    log(f"K4 backward by kernel: {counts} (bf16 aligned mma; f32 and "
        "unaligned bf16 fma)")
    for tag, shape, causal in BWD_TIMED:
        B, H, KV, Tq, Tk, hd = shape
        set_bytes = (3 * B * H * Tq + 2 * B * KV * Tk) * hd * 2
        sets = [_bwd_inputs(gen, shape, causal, torch.bfloat16)
                for _ in range(max(2, -(-2 * L2_BYTES // set_bytes)))]

        def kern(q, k, v, dout, lse):
            return fa.flash_attention_backward(q, k, v, dout, lse,
                                               causal=causal)

        def fma(q, k, v, dout, lse):
            # the CUDA-core kernel it replaces, called directly (uncounted)
            dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
            fa.run_backward(fa.backward_kernel("fma", torch.bfloat16), q, k,
                            v, dout, lse, dq, dk, dv, causal=causal)
        n0 = dict(counts)
        ms = time_ms(kern, sets, iters=20)
        dev_ms = device_ms(kern, sets, BWD_MMA_NAMES, iters=20)
        split = {name.strip(":<"): device_ms(kern, sets, (name,), iters=20)
                 for name in BWD_MMA_NAMES}
        if counts["fma"] != n0["fma"] or counts["mma"] == n0["mma"]:
            raise AssertionError(f"K4 backward {tag}: timed calls took "
                                 f"{counts}, not the mma kernel alone")
        fma_ms = time_ms(fma, sets, iters=6)
        fma_dev_ms = device_ms(fma, sets, BWD_FMA_NAMES, iters=6)
        plain_ms = time_ms(lambda q, k, v, dout, lse:
                           flash_attention_bwd_ref(q, k, v, dout, lse,
                                                   causal=causal),
                           sets[:1], iters=3)
        # the yardstick: SDPA's backward alone, on a graph kept for reuse
        lib = []
        for q, k, v, dout, lse in sets:
            leaves = [t.detach().clone().requires_grad_(True)
                      for t in (q, k, v)]
            out = F.scaled_dot_product_attention(*leaves, is_causal=causal,
                                                 enable_gqa=True)
            lib.append((out, leaves, dout))
        lib_ms = time_ms(lambda out, leaves, dout: torch.autograd.grad(
            out, leaves, dout, retain_graph=True), lib, iters=20)
        b_ms, b_by = flash_bwd_bound(shape, causal, 2)
        timed.append({"tag": tag, "shape": list(shape), "causal": causal,
                      "dtype": "bfloat16", "kernel": "mma", "ms": ms,
                      "device_ms": dev_ms, "device_ms_by_kernel": split,
                      "fma_ms": fma_ms, "fma_device_ms": fma_dev_ms,
                      "plain_ms": plain_ms, "library_ms": lib_ms,
                      "bound_ms": b_ms, "bound_by": b_by,
                      "max_abs_err": max_err})
        log(f"K4 backward {tag} {shape} causal={causal} bf16: kernel mma "
            f"{ms:.4f} ms (device {fmt_ms(dev_ms)}: "
            + ", ".join(f"{k} {fmt_ms(v)}" for k, v in split.items())
            + f"), the CUDA-core kernel it replaces {fma_ms:.4f} ms (device "
            f"{fmt_ms(fma_dev_ms)}), plain {plain_ms:.4f} ms, "
            f"scaled_dot_product_attention's backward {lib_ms:.4f} ms, "
            f"bound {b_ms:.4f} ms ({b_by})")
        del sets, lib
        free_cuda()
    return {"max_abs_err": max_err, "checked": checked,
            "planted_faults": faults, "shapes": timed,
            "variant_launches": dict(counts),
            "check_launches": fa.flash_attention_backward.launches - before}


def bwd_planted_faults(tag, shape, causal, q, k, v, dout, lse, refs, abss,
                       rss):
    """The tensor-core kernel without its last key tile (dq) and without
    its last query block (dk, dv), against the unfaulted plain gradients:
    each must exceed its rounding limit."""
    from repro_torch.kernels import flash_attention as fa
    Tq, Tk = shape[3], shape[4]
    drop_k = Tk - (Tk - 1) // 64 * 64
    drop_q = Tq - (Tq - 1) // 64 * 64
    out = []
    dq, _, _ = fa.flash_attention_backward(
        q, k[:, :, :-drop_k], v[:, :, :-drop_k], dout, lse, causal=causal)
    x = bwd_excess(dq, refs[0], abss[0], "bfloat16", rss[0])
    out.append({"tag": tag, "fault": f"dq without its last {drop_k} keys",
                "round_excess": x})
    _, dk, dv = fa.flash_attention_backward(
        q[:, :, :-drop_q], k, v, dout[:, :, :-drop_q],
        lse[:, :, :-drop_q].contiguous(), causal=causal)
    x2 = max(bwd_excess(dk, refs[1], abss[1], "bfloat16", rss[1]),
             bwd_excess(dv, refs[2], abss[2], "bfloat16", rss[2]))
    out.append({"tag": tag, "fault": f"dk, dv without the last {drop_q} "
                "query rows", "round_excess": x2})
    for f in out:
        log(f"K4 backward planted fault, {tag} {shape}, {f['fault']}: "
            f"{f['round_excess']:.3f}x the tensor-core rounding limit (must "
            "be > 1)")
        if not f["round_excess"] > 1.0:
            raise AssertionError(f"K4 backward rounding limit has no teeth: "
                                 f"{tag} {f['fault']} passes")
    return out


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


def expected_streamed_by_dtype(ex, segments=None):
    """The ledger, by storage format (``meta["quant"]``): every pass
    streams exactly its tier plan's streamed placements that are not
    pinned. ``segments``: for a run whose plan changed mid-serve (a
    degradation rung), ``(first pass, schedule, pinned names)`` from each
    change on; else the executor's schedule and pins throughout."""
    segments = segments or [(0, ex.schedule, set(ex._pinned))]
    out = {}
    for i, t in enumerate(ex.stats.tiers_used):
        _, schedule, pinned = max((seg for seg in segments if seg[0] <= i),
                                  key=lambda seg: seg[0])
        for p in schedule.tiers[t].plan.static_stream_order():
            if p.sub.name not in pinned:
                q = p.sub.meta.get("quant", "fp16")
                out[q] = out.get(q, 0) + p.sub.weight_bytes
    return out


def kv_device_bytes(sess):
    """The KV cache's device bytes: the stacked (L, B, KV, S, hd) pair at
    the batcher's batch and the session's ``max_seq``, or a paged cache's
    two page pools (the null page included)."""
    from repro_torch.core.kvpaged import PagedKVCache
    cfg = sess.cfg
    kv = sess._batcher.kv if sess._batcher is not None else None
    if isinstance(kv, PagedKVCache):
        return 2 * kv.n_pages * kv.page_bytes
    batch = sess._batcher_cfg[0] if sess._batcher_cfg else MAX_BATCH
    return 2 * cfg.n_layers * batch * cfg.n_kv_heads * sess.max_seq \
        * cfg.resolved_head_dim * 2


def memory_bound(sess, tiers=None):
    """Peak device bytes the plan allows, with everything the executor
    keeps outside the planned budget counted in. For MoE: the at-use term
    covers the router, expert and whole-MoE sub-layers, and the (E, C, d)
    dispatch and output buffers are counted at the most rows C the run
    held at once (``ExecStats.moe_rows_peak``). A paged session counts its
    page pools in place of the stacked cache; a speculative one adds the
    draft's pinned weights (its schedule's, all of them), its stacked
    cache and its embedding, norm and head."""
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
    # the tiers the run used (``tiers``: those used since a rung)
    tiers = set(ex.stats.tiers_used if tiers is None else tiers) \
        or set(sess.schedule.tiers)
    scratch = max(sess.schedule.tiers[t].scratch_bytes for t in tiers)
    at_use = max(groups_nbytes(ex._subtree(s)) for s in sess.subs
                 if s.kind in ("attn", "ffn", "moe", "moe_router",
                               "moe_expert"))
    resident = tree_nbytes({k: ex.host[k] for k in ex.host})
    parts = {"pinned": pinned, "scratch": scratch, "at_use_one_sublayer":
             at_use, "kv": kv_device_bytes(sess), "embed_norm_head": resident,
             "activations": ACT_ALLOWANCE}
    if cfg.moe is not None:
        parts["moe_dispatch_and_output"] = \
            2 * cfg.moe.n_experts * ex.stats.moe_rows_peak * cfg.d_model * 2
    if sess._spec_decoder is not None:
        dex = sess._spec_decoder.ex
        dcfg = sess.draft_cfg
        dpins = sess.draft_schedule.pinned_placements()
        if set(dex._pinned) != {pl.sub.name for pl in dpins}:
            raise AssertionError("the draft pins other sub-layers than its "
                                 "schedule")
        parts["draft_pinned"] = int(sum(pl.sub.weight_bytes for pl in dpins))
        parts["draft_kv"] = 2 * dcfg.n_layers * MAX_BATCH \
            * dcfg.n_kv_heads * MAX_SEQ * dcfg.resolved_head_dim * 2
        parts["draft_embed_norm_head"] = tree_nbytes(
            {k: dex.host[k] for k in dex.host})
    return sum(parts.values()), parts


def serve_once(cfg, params, db, system, budget, *, overlap=True,
               fused=True, prefill_mode=None, rebudget_to=None,
               rebudget_after=2, n_req=N_REQ, new_tokens=NEW_TOKENS,
               requests=None, on_open=None, **open_kw):
    """One Session.open -> serve run at ``budget``. ``requests``: a
    function making the wave (fresh Request objects), else ``n_req``
    random prompts of PROMPT_LEN tokens; ``open_kw`` go to Session.open
    (expert_granular, kv_layout, kv_pool_pages, draft_cfg, draft_params,
    spec_k, faults, recovery); ``on_open(sess)`` runs once the executor
    and the batcher are built, before the first request."""
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
                        **open_kw)
    # build the executor (weights placed on the card) before the requests
    # arrive, so TTFT counts serving and not set-up
    batcher = sess.batcher(max_batch=MAX_BATCH, fused=fused)
    if on_open is not None:
        on_open(sess)
    torch.cuda.synchronize()
    reqs = requests() if requests is not None else \
        random_requests(cfg.vocab, n_req, PROMPT_LEN, new_tokens, seed=0)
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
           "at_use_mb": ex["at_use_bytes"] / 1e6,
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
        f"MB {by_dtype}, staged {row['staged_mb']:.1f} MB, at use "
        f"{row['at_use_mb']:.1f} MB, tiers {row['tiers']} "
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
        k1_before = read_launches()["K1"]
        run = serve_once(cfg, params, db, system, int(total * frac))
        run["k1"] = read_launches()["K1"] - k1_before
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

    # ---- phase 12: paged KV at 0.1x, against the stacked tokens
    paged = paged_path(cfg, params, db, system, total, runs[0.1]["tokens"])
    return {"rows": rows, "launches": main_launches, "variants": variants,
            "link_gbps": link,
            "profile": prof, "quant": quant, "paged": paged,
            "model": (cfg, params),
            "base_01": {k: runs[0.1][k] for k in ("tokens", "k1",
                                                  "streamed_bytes")},
            "setup": (db, system, total)}


KERNEL_OF = {"int8": "K2", "int4": "K3"}


def _counters():
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import streamed_matmul as sm
    return {"K1": sm.streamed_matmul, "K2": sm.streamed_matmul_int8,
            "K3": sm.streamed_matmul_int4, "K4": fa.flash_attention,
            "K4bwd": fa.flash_attention_backward}


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


class _LaunchesIn:
    """Counts the K1 launches made inside ``cls``'s methods ``names``
    while installed (a speculative run's draft)."""

    def __init__(self, cls, *names):
        self.cls = cls
        self.real = {n: getattr(cls, n) for n in names}
        self.launches = 0

    def __enter__(self):
        k1 = _counters()["K1"]
        for name, real in self.real.items():
            def counted(*a, _real=real, **kw):
                before = k1.launches
                try:
                    return _real(*a, **kw)
                finally:
                    self.launches += k1.launches - before
            setattr(self.cls, name, counted)
        return self

    def __exit__(self, *exc):
        for name, real in self.real.items():
            setattr(self.cls, name, real)
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


# ------------------------------------------------------------ phase 12
# the forced pool: 64 usable pages against the main path's 480 live blocks
# (24 layers x 4 slots x 5 blocks of 16 tokens) and one layer's 20
FORCED_POOL = 64
PREFIX_LEN, SUFFIX_LEN = 48, 16      # 3 full shared blocks, then 1 own


def staggered_wave(vocab, n=6):
    """Six requests of 40 to 80 prompt tokens and 8 to 28 new ones: with
    ``max_batch=4`` the last two are admitted as earlier ones retire, so
    slots sit at different positions and a page's blocks turn over."""
    import numpy as np
    from repro_torch.core.serving import Request
    rng = np.random.RandomState(1)
    return [Request(rid=i, prompt=rng.randint(0, vocab, size=40 + 8 * i)
                    .astype(np.int32), max_new_tokens=8 + 4 * i)
            for i in range(n)]


def prefix_wave(vocab, n=N_REQ):
    """``n`` prompts sharing a PREFIX_LEN-token system prompt, each with a
    SUFFIX_LEN-token question of its own."""
    import numpy as np
    from repro_torch.core.serving import Request
    rng = np.random.RandomState(2)
    shared = rng.randint(0, vocab, size=PREFIX_LEN).astype(np.int32)
    return [Request(rid=i, prompt=np.concatenate(
        [shared, rng.randint(0, vocab, size=SUFFIX_LEN).astype(np.int32)]),
        max_new_tokens=NEW_TOKENS) for i in range(n)]


def expected_prefix_counts(prompts, page_size):
    """What ``prefix_attach`` counts for prompts admitted in this order,
    each registering its full blocks after its prefill: a query per
    prompt; a hit per prompt whose leading full blocks (its chained block
    keys) were registered before, matched up to one token short of the
    prompt; the matched blocks summed."""
    seen = set()
    hits = blocks = 0
    for p in prompts:
        keys, prev = [], ("kv-prefix",)
        for j in range(len(p) // page_size):
            prev = (prev, tuple(int(t) for t in
                                p[j * page_size:(j + 1) * page_size]))
            keys.append(prev)
        matched = 0
        for key in keys:
            if key not in seen or (matched + 1) * page_size >= len(p):
                break
            matched += 1
        hits += matched > 0
        blocks += matched
        seen.update(keys)
    return {"prefix_queries": len(prompts), "prefix_hits": hits,
            "prefix_hit_blocks": blocks}


def paged_checks(tag, run):
    """One paged run's gates: the ledger (streamed == static plan +
    demanded experts + demanded pages, per dtype, pages as "kv"), peak
    memory within the bound (the pools in place of the stacked cache).
    Returns the summary row with the page counters."""
    row = summarise(tag, run)
    sess = run["sess"]
    ex = sess.executor
    st = sess.stats()["serving"]["paged_kv"]
    by, lim, parts = ledger_and_bound(tag, run)
    if st["demanded_page_bytes"] != ex.stats.demanded_page_bytes or \
            st["page_faults"] != ex.stats.page_faults:
        raise AssertionError(f"{tag}: cache and executor page counters "
                             f"differ: {st}")
    steps = max(ex.stats.decode_passes, 1)
    log(f"  pages: pool {st['n_pages'] - 1} of {st['page_size']} tokens "
        f"({st['pool_bytes']} B), evictions {st['evictions']} "
        f"({st['evictions'] / steps:.2f} per decode step), faults "
        f"{st['page_faults']} ({st['page_faults'] / steps:.2f} per decode "
        f"step, {st['demanded_page_bytes']} B demanded), prefix hits "
        f"{st['prefix_hits']} of {st['prefix_queries']} "
        f"({st['prefix_hit_blocks']} blocks); ledger: streamed "
        f"{ex.stats.streamed_bytes} B == static plan + demanded {by}")
    row.update({k: st[k] for k in ("n_pages", "pool_bytes", "evictions",
                                   "page_faults", "demanded_page_bytes",
                                   "prefix_queries", "prefix_hits",
                                   "prefix_hit_blocks", "cow_copies")})
    row.update({"decode_passes": ex.stats.decode_passes,
                "evictions_per_decode_step": st["evictions"] / steps,
                "faults_per_decode_step": st["page_faults"] / steps,
                "streamed_bytes_by_dtype": by,
                "bound_bytes": lim, "bound_parts": parts})
    return row


def paged_path(cfg, params, db, system, total, stacked):
    """Phase 12: qwen2-0.5b served paged at 0.1x, the main path's wave
    with the planner's pool and with FORCED_POOL pages (pipelined and
    sync), a staggered wave, and a shared-prefix wave; each against
    stacked serving of the same requests."""
    budget = int(total * 0.1)
    rows = {}
    launches = {"K1": 0, "mma": 0, "fma": 0}

    def serve(tag, stacked_tokens=None, **kw):
        # the counts cover this paged run alone: the stacked twins it is
        # held against run outside the window
        reset_launches()
        run = serve_once(cfg, params, db, system, budget,
                         kv_layout="paged", **kw)
        counts, variants = read_launches(), read_variants()
        if counts["K1"] <= 0 or variants["K1"] != {"mma": counts["K1"],
                                                   "fma": 0} \
                or (counts["K2"], counts["K3"], counts["K4"]) != (0, 0, 0):
            raise AssertionError(f"paged {tag}: launches {counts} by "
                                 f"kernel {variants}")
        launches["K1"] += counts["K1"]
        for key, n in variants["K1"].items():
            launches[key] += n
        row = paged_checks(f"paged {tag} 0.1x", run)
        row["k1_launches"] = counts["K1"]
        if stacked_tokens is not None and run["tokens"] != stacked_tokens:
            raise AssertionError(f"paged {tag}: tokens differ from stacked "
                                 "serving")
        rows[tag] = row
        return run, row

    run, _ = serve("planner pool", stacked)
    run["sess"].close()
    forced_tag = f"pool {FORCED_POOL}"
    run, forced = serve(forced_tag, stacked, kv_pool_pages=FORCED_POOL)
    run["sess"].close()
    if forced["evictions"] <= 0 or forced["page_faults"] <= 0:
        raise AssertionError(f"the forced pool of {FORCED_POOL} pages never "
                             f"evicted or restored: {forced}")
    log(f"paged at 0.1x, planner's pool ({rows['planner pool']['n_pages'] - 1}"
        f" pages) and {FORCED_POOL} pages: tokens identical to stacked")
    run, _ = serve(f"{forced_tag} sync", stacked, kv_pool_pages=FORCED_POOL,
                   overlap=False)
    run["sess"].close()
    log(f"paged overlap == sync at 0.1x with {FORCED_POOL} pages: tokens "
        "identical")

    wave = functools.partial(staggered_wave, cfg.vocab)
    srun = serve_once(cfg, params, db, system, budget, requests=wave)
    srun["sess"].close()
    run, _ = serve(f"staggered {forced_tag}", srun["tokens"],
                   kv_pool_pages=FORCED_POOL, requests=wave)
    run["sess"].close()
    log(f"staggered wave of 6 at max_batch {MAX_BATCH}, {FORCED_POOL} pages: "
        "tokens identical to stacked")

    pwave = functools.partial(prefix_wave, cfg.vocab)
    prun = serve_once(cfg, params, db, system, budget, requests=pwave)
    prun["sess"].close()
    run, prow = serve("prefix", prun["tokens"], requests=pwave)
    want = expected_prefix_counts([r.prompt for r in run["reqs"]],
                                  run["sess"].executor.kv_page_size)
    got = {k: prow[k] for k in want}
    if got != want or prow["cow_copies"]:
        raise AssertionError(f"prefix counters {got} (cow "
                             f"{prow['cow_copies']}) != {want}")
    prefix_tokens = [p["prefix_tokens"]
                     for p in run["sess"].executor.stats.prefill_stats]
    log(f"prefix wave ({N_REQ} prompts sharing {PREFIX_LEN} tokens): tokens "
        f"identical to stacked; counters {got} == what the prompts imply; "
        f"prefix tokens per admission {prefix_tokens}")
    est = run["sess"].estimates(PROMPT_LEN, prefix_hit_frac=0.75)
    log(f"Session.estimates({PROMPT_LEN}, prefix_hit_frac=0.75): {est}")
    run["sess"].close()
    variants = {"mma": launches["mma"], "fma": launches["fma"]}
    log(f"K1 launches on the paged path: {launches['K1']}, in the paged "
        f"runs alone, each > 0, all mma (by kernel {variants}; per run "
        f"{ {t: r['k1_launches'] for t, r in rows.items()} })")
    return {"rows": rows, "launches": launches["K1"],
            "variants": variants, "estimates": est,
            "prefix_tokens": prefix_tokens}


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


def ledger_and_bound(tag, run):
    """A run's ledger, per dtype: streamed == static plan + demanded
    expert bytes (under the experts' format) + demanded page bytes (as
    "kv"); and its peak device memory within ``memory_bound``. Returns
    (streamed bytes by dtype, bound, its parts)."""
    sess = run["sess"]
    ex = sess.executor
    by = dict(ex.stats.streamed_bytes_by_dtype)
    want = expected_streamed_by_dtype(ex)
    if ex.stats.demanded_expert_bytes:
        q = next(s.meta["quant"] for s in sess.subs
                 if s.kind == "moe_expert")
        want[q] = want.get(q, 0) + ex.stats.demanded_expert_bytes
    if ex.stats.demanded_page_bytes:
        want["kv"] = ex.stats.demanded_page_bytes
    if by != want or sum(by.values()) != ex.stats.streamed_bytes:
        raise AssertionError(f"{tag}: streamed by dtype {by} != static plan "
                             f"+ demanded experts + demanded pages {want}")
    lim, parts = memory_bound(sess)
    log(f"  peak device memory {run['peak']} B <= bound {lim} B {parts}")
    if run["peak"] > lim:
        raise AssertionError(f"{tag}: peak {run['peak']} > {lim}")
    return by, lim, parts


def moe_run_checks(tag, run, cfg):
    """One MoE run's gates: ``ledger_and_bound`` (and a paged run's
    ``paged_checks``), and each decode step's demanded experts per layer
    <= active tokens x top_k. Returns the summary row."""
    sess = run["sess"]
    ex = sess.executor
    if sess.kv_layout == "paged":
        row = paged_checks(tag, run)
        by, lim, parts = (row["streamed_bytes_by_dtype"], row["bound_bytes"],
                          row["bound_parts"])
    else:
        row = summarise(tag, run)
        by, lim, parts = ledger_and_bound(tag, run)
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
        + [("granular-sync", 0.1, dict(overlap=False)),
           ("granular-paged", 0.5, dict(kv_layout="paged"))]
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
        "2.0x, 0.5x, sync 0.1x and paged granular 0.5x: True")
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
        want = {"K1": route.calls, "K2": 0, "K3": 0, "K4": 0, "K4bwd": 0}
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
        tiers = moe_tier_runs(serve, qcfg, qparams, qtot, qtag) \
            if qtag == "int8-experts" else None
        out["quant"][qtag] = {
            "rows": {f"{t} {f}x": {k: v for k, v in r.items()
                                   if k not in ("tokens", "prompts")}
                     for (t, f), r in qrows.items()},
            "kernel": kname, "launches": want[kname],
            "variants": variants[kname], "weight_bytes": qtot,
            "teacher_forced_gap": qgap, "forced_prefill_tiers": tiers}
        del qparams
        free_cuda()
    # ---- phase 14, MoE: faults on phase 11's weights and wave, last: a
    # re-plan folds the routing EMA into its profile DB, a fresh one here
    out["faults"] = moe_fault_runs(
        cfg, params, run_install(system), system, tot, base,
        rows[("granular", 0.1)]["streamed_bytes"])
    del params
    free_cuda()
    return out


def moe_tier_runs(serve, cfg, params, tot, tag):
    """Granular 0.5x with every prefill forced onto tier 32, then 64 (the
    MoE tier item of ROADMAP.md: AI1's int8-expert tokens changed with the
    prefill tier). Outside the counted runs; printed, not gated."""
    from repro_torch.core import planner
    real = planner.Schedule.pick_prefill_tier
    tokens = {}
    for tier in (32, 64):
        planner.Schedule.pick_prefill_tier = \
            lambda self, *a, _t=tier, **kw: _t
        try:
            tokens[tier] = serve(cfg, params, tot, f"{tag} granular tier "
                                 f"{tier}", 0.5)["tokens"]
        finally:
            planner.Schedule.pick_prefill_tier = real
    equal = tokens[32] == tokens[64]
    log(f"moe {tag} granular 0.5x, prefill forced to tier 32 and to 64: "
        f"tokens identical {equal}")
    return {"tokens_identical": equal}


# ------------------------------------------------------------ phase 13
SPEC_ARCH = "qwen3-14b"
SPEC_LAYERS = 10         # of 40: every layer has the same shapes
SPEC_K = 3
SPEC_WIDTH = SPEC_K + 1


def _copy_tree(dst, src, i):
    for k, v in src.items():
        if isinstance(v, dict):
            _copy_tree(dst[k], v, i)
        else:
            dst[k][i].copy_(v)


def dense_host_params(cfg):
    """Seeded bf16 weights of a dense decoder in the reference's stacked
    layout in pinned host memory, each layer drawn on the card by the
    port's own init and copied back, one layer at a time."""
    import torch
    from repro_torch.models.common import dense_init, tree_map
    from repro_torch.models.transformer import init_layer_params
    gen = torch.Generator(device="cuda").manual_seed(0)
    L, d, V = cfg.n_layers, cfg.d_model, cfg.vocab
    bf = torch.bfloat16
    layers = None
    for i in range(L):
        lp = init_layer_params(gen, cfg, bf)
        if layers is None:
            layers = tree_map(
                lambda t: _pinned((L,) + tuple(t.shape), t.dtype), lp)
        _copy_tree(layers, lp, i)
        del lp
    embed = _pinned((V, d), bf)
    embed.copy_(dense_init(gen, (V, d), 1, bf))
    out = {"embed": embed, "layers": layers,
           "final_norm": _pinned((d,), bf, 1.0)}
    if not cfg.tie_embeddings:
        out["unembed"] = _pinned((d, V), bf)
        out["unembed"].copy_(dense_init(gen, (d, V), 0, bf))
    torch.cuda.synchronize()
    return out


def verify_check(cfg, params, schedule, layout):
    """``_run_verify`` over a window of SPEC_WIDTH against as many
    ``_run_decode`` calls, on two caches prefilled alike: the logits
    ``torch.equal`` column by column, and the caches equal after."""
    import numpy as np
    import torch
    from repro_torch.core.executor import PipelinedExecutor
    ex = PipelinedExecutor(cfg, params, schedule, max_seq=MAX_SEQ,
                           kv_layout=layout)
    rng = np.random.RandomState(5)
    lens = [PROMPT_LEN - 3 * i for i in range(MAX_BATCH)]
    prompts = [rng.randint(0, cfg.vocab, size=n).astype(np.int32)
               for n in lens]
    window = torch.as_tensor(rng.randint(0, cfg.vocab, size=(
        MAX_BATCH, SPEC_WIDTH)).astype(np.int32), device="cuda")
    pos = torch.as_tensor(np.asarray(lens, np.int32), device="cuda")
    act = torch.ones((MAX_BATCH,), dtype=torch.bool, device="cuda")
    caches = []
    for _ in range(2):
        kv = ex.init_kv(MAX_BATCH)
        for s, p in enumerate(prompts):
            ex.prefill(torch.as_tensor(p)[None], kv=kv, slot=s)
        caches.append(kv)
    seq = []
    for j in range(SPEC_WIDTH):
        lg, _ = ex._run_decode(window[:, j:j + 1], caches[0], pos + j, act,
                               n_active=MAX_BATCH)
        seq.append(lg[:, -1])
    ver, _ = ex._run_verify(window, caches[1], pos, act, n_active=MAX_BATCH)
    torch.cuda.synchronize()
    for j in range(SPEC_WIDTH):
        if not torch.equal(ver[:, j], seq[j]):
            diff = (ver[:, j].float() - seq[j].float()).abs().max().item()
            raise AssertionError(f"{layout}: verify column {j} != decode "
                                 f"step {j} (max |diff| {diff})")
    if layout == "stacked":
        same = all(torch.equal(caches[0][k], caches[1][k]) for k in "kv")
    else:
        a, b = caches
        same = bool((a.bids == b.bids).all()) and all(
            torch.equal(a.k_pool[a.layer_table(i)], b.k_pool[b.layer_table(i)])
            and torch.equal(a.v_pool[a.layer_table(i)],
                            b.v_pool[b.layer_table(i)])
            for i in range(cfg.n_layers))
    if not same:
        raise AssertionError(f"{layout}: the verify pass left another cache "
                             "than the decode steps")
    entry = ex.stats.verify_pass_stats[-1]
    log(f"verify == {SPEC_WIDTH} sequential decode steps at full width, "
        f"{layout}: logits torch.equal, caches equal; the pass streamed "
        f"{entry['streamed_bytes']} B once for {MAX_BATCH * SPEC_WIDTH} rows "
        f"(the decode steps {SPEC_WIDTH} x "
        f"{ex.stats.pass_streamed_bytes[-1]} B)")
    del ex, caches
    free_cuda()
    return entry


def spec_checks(tag, run, plain_tokens):
    """One speculative run's gates: tokens equal to plain greedy decode,
    the draft streamed nothing, every verify pass's ledger exact (streamed
    == static plan + demanded experts + demanded pages),
    drafted == accepted + rolled back, peak within the bound with the
    draft counted. Returns the summary row."""
    row = summarise(tag, run)
    sess = run["sess"]
    ex = sess.executor
    srv = sess.stats()["serving"]
    if not sess.spec_active or srv["spec_verify_passes"] <= 0:
        raise AssertionError(f"{tag}: speculation did not run: {srv}")
    if run["tokens"] != plain_tokens:
        raise AssertionError(f"{tag}: speculative tokens differ from plain "
                             "greedy decode")
    if srv["draft"]["streamed_bytes"] != 0 or \
            sess.spec_decoder(MAX_BATCH).ex.prefetch is not None:
        raise AssertionError(f"{tag}: the draft streamed: {srv['draft']}")
    for e in ex.stats.verify_pass_stats:
        if e["streamed_bytes"] != e["static_plan_bytes"] \
                + e["demanded_expert_bytes"] + e["demanded_page_bytes"]:
            raise AssertionError(f"{tag}: verify pass ledger {e}")
    if srv["spec_drafted"] != srv["spec_accepted"] \
            + srv["spec_rolled_back_tokens"]:
        raise AssertionError(f"{tag}: drafted != accepted + rolled back: "
                             f"{srv}")
    _, lim, parts = ledger_and_bound(tag, run)
    log(f"  spec: k={srv['spec_k']}, {srv['spec_verify_passes']} verify "
        f"passes, drafted {srv['spec_drafted']}, accepted "
        f"{srv['spec_accepted']} (rate {srv['accept_rate']:.4f}), rolled "
        f"back {srv['spec_rolled_back_tokens']}; draft "
        f"{srv['draft']}; every verify ledger exact")
    row.update({k: srv[k] for k in ("spec_k", "spec_verify_passes",
                                    "spec_drafted", "spec_accepted",
                                    "accept_rate",
                                    "spec_rolled_back_tokens")})
    row.update({"draft_carve_bytes": sess.draft_carve_bytes,
                "bound_bytes": lim, "bound_parts": parts})
    return row


def spec_path(link, draft_cfg, draft_params):
    """Phase 13: qwen3-14b at its published widths, SPEC_LAYERS of 40
    layers, with qwen2-0.5b (full size, seeded random weights) as its
    draft at k = SPEC_K, and the target as its own draft."""
    import torch
    from repro_torch import Session
    from repro_torch.configs import get_config
    from repro_torch.core import (SYSTEMS, InferenceSetting, build_graph,
                                  run_install, specdec, total_weight_bytes)
    cfg = get_config(SPEC_ARCH).replace(n_layers=SPEC_LAYERS)
    system = SYSTEMS["h100"].with_(link_gbps=link)
    db = run_install(system)
    t0 = time.perf_counter()
    params = dense_host_params(cfg)
    total = total_weight_bytes(build_graph(cfg))
    log(f"{SPEC_ARCH} at its published widths (d={cfg.d_model}, "
        f"{cfg.n_heads}/{cfg.n_kv_heads} heads, hd={cfg.resolved_head_dim}, "
        f"f={cfg.d_ff}, vocab={cfg.vocab}), {cfg.n_layers} of 40 layers, "
        f"{total} B of graph: weights drawn on the card and pinned in "
        f"{time.perf_counter() - t0:.1f} s; draft {draft_cfg.name} at full "
        f"size, k={SPEC_K}")
    warm = serve_once(cfg, params, db, system, int(total * 0.5), n_req=1,
                      new_tokens=2)
    warm["sess"].close()
    del warm
    schedule = Session.open(cfg, system=system,
                            budget_bytes=int(total * 0.5),
                            setting=InferenceSetting(batch=MAX_BATCH,
                                                     context=MAX_SEQ),
                            db=db, max_seq=MAX_SEQ).schedule
    verify = {layout: verify_check(cfg, params, schedule, layout)
              for layout in ("stacked", "paged")}
    draft = dict(draft_cfg=draft_cfg, draft_params=draft_params,
                 spec_k=SPEC_K)
    rows, plain = {}, {}
    launches = {"K1": 0, "mma": 0, "fma": 0, "draft": 0}
    for frac, layout, kw in ((0.5, "stacked", draft),
                             (0.5, "paged", draft),
                             (1.8, "stacked",
                              dict(draft_cfg=cfg, draft_params=params,
                                   spec_k=SPEC_K))):
        tag = f"{frac}x {layout}" + (" self" if kw["draft_cfg"] is cfg
                                     else "")
        run = serve_once(cfg, params, db, system, int(total * frac),
                         kv_layout=layout)
        rows[f"plain {tag}"] = summarise(f"{SPEC_ARCH} plain {tag}", run)
        run["sess"].close()
        plain.setdefault("tokens", run["tokens"])
        if run["tokens"] != plain["tokens"]:
            raise AssertionError(f"plain {tag}: tokens differ from plain "
                                 "0.5x stacked")
        # the counts cover this speculative run alone (the plain twin and
        # the verify checks run outside the window); the draft's own
        # launches are counted apart
        reset_launches()
        with _LaunchesIn(specdec.SpecDecoder, "prefill_slot",
                         "draft") as in_draft:
            run = serve_once(cfg, params, db, system, int(total * frac),
                             kv_layout=layout, **kw)
        counts, variants = read_launches(), read_variants()
        target = counts["K1"] - in_draft.launches
        if target <= 0 or in_draft.launches <= 0 \
                or variants["K1"] != {"mma": counts["K1"], "fma": 0} \
                or (counts["K2"], counts["K3"], counts["K4"]) != (0, 0, 0):
            raise AssertionError(f"spec {tag}: launches {counts} by kernel "
                                 f"{variants}, {in_draft.launches} of K1 "
                                 "in the draft")
        launches["K1"] += target
        launches["draft"] += in_draft.launches
        for key, n in variants["K1"].items():
            launches[key] += n
        rows[f"spec {tag}"] = spec_checks(f"{SPEC_ARCH} spec {tag}", run,
                                          plain["tokens"])
        rows[f"spec {tag}"].update({"k1_launches_target": target,
                                    "k1_launches_draft": in_draft.launches})
        run["sess"].close()
        del run
        free_cuda()
    self_rate = rows["spec 1.8x stacked self"]["accept_rate"]
    if self_rate <= 0.6:
        raise AssertionError(f"self-speculation accepted {self_rate:.4f} "
                             "of its drafts, not more than 0.6")
    log(f"speculative tokens == plain greedy at 0.5x stacked and paged and "
        f"at 1.8x with self-speculation (accept rate {self_rate:.4f} > 0.6)")
    for tag in ("0.5x stacked", "0.5x paged", "1.8x stacked self"):
        p, sp = rows[f"plain {tag}"], rows[f"spec {tag}"]
        log(f"{SPEC_ARCH} {tag}: spec {sp['decode_tps']:.2f} tok/s, TTFT "
            f"{sp['ttft_s']:.4f} s against plain {p['decode_tps']:.2f} "
            f"tok/s, TTFT {p['ttft_s']:.4f} s (accept rate "
            f"{sp['accept_rate']:.4f})")
    variants = {"mma": launches["mma"], "fma": launches["fma"]}
    log(f"K1 launches on the spec path: {launches['K1']} by the target and "
        f"{launches['draft']} by the draft, in the speculative runs alone, "
        f"each > 0, all mma (by kernel {variants})")
    # ---- phase 14, speculative: spec_off under an alloc.device
    fault = spec_fault_run(cfg, params, db, system, total, draft,
                           plain["tokens"])
    del params
    free_cuda()
    return {"rows": rows, "verify": verify, "launches": launches["K1"],
            "draft_launches": launches["draft"], "variants": variants,
            "layers": cfg.n_layers, "weight_bytes": total, "faults": fault}


# ------------------------------------------------------------ phase 14
# a faulted run still going after this many seconds fails the phase
FAULT_WALL_S = 300.0


def guarded(tag, fn, seconds=FAULT_WALL_S, grace=30.0):
    """``fn()`` under a wall-clock guard. It runs on this thread, where
    the earlier phases served (a thread of its own would bring its own
    cuBLAS handle and 32 MiB workspace into the peak); a watchdog thread
    interrupts it after ``seconds`` and the interrupt is raised as a
    ``TimeoutError``, so a hang fails the phase. A hang the interrupt
    cannot reach (inside a CUDA call) ends the process with exit code 3
    after ``grace`` seconds more, so the script never stalls."""
    import os
    import signal
    done, fired = threading.Event(), []
    main = threading.main_thread().ident

    def watchdog():
        if done.wait(seconds):
            return
        fired.append(True)
        log(f"{tag}: still running after {seconds:.0f} s (the wall-clock "
            "guard); interrupting")
        # a real signal: it also wakes a wait on a lock or an event
        signal.pthread_kill(main, signal.SIGINT)
        if not done.wait(grace):
            log(f"{tag}: the interrupt did not land in {grace:.0f} s; "
                "exiting")
            os._exit(3)

    threading.Thread(target=watchdog, name=f"guard {tag}",
                     daemon=True).start()
    try:
        return fn()
    except KeyboardInterrupt:
        if fired:
            raise TimeoutError(f"{tag}: still running after {seconds:.0f} s "
                               "(the wall-clock guard)") from None
        raise
    finally:
        done.set()


class RungWatch:
    """Watches a session's ladder (``on_open`` of ``serve_once``): at each
    rung ``degrade`` applies it gates the peak so far against the plan
    before the rung, prints the card's reserved bytes before and after
    the rung (which releases cached blocks), records where the plan
    changed (for the ledger) and resets the peak, so the run's peak is the
    one under the plan after the last rung."""

    def __init__(self, tag):
        self.tag = tag
        self.rungs = []
        self.segments = None

    def __call__(self, sess):
        import torch
        from repro_torch.core import DEGRADATION_RUNGS
        ex = sess.executor
        self.segments = [(0, sess.schedule, set(ex._pinned))]
        degrade = sess.degrade

        def watched(reason=""):
            used = ex.stats.tiers_used[self.segments[-1][0]:]
            lim, _ = memory_bound(sess, tiers=used)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated()
            before = torch.cuda.memory_reserved()
            level = degrade(reason=reason)
            torch.cuda.synchronize()
            after = torch.cuda.memory_reserved()
            if level is None:
                return level
            rung = DEGRADATION_RUNGS[level]
            n = len(ex.stats.tiers_used)
            log(f"  {self.tag}: rung {rung} (level {level}) after pass {n}: "
                f"peak before it {peak} B <= bound {lim} B; reserved "
                f"{before} -> {after} B")
            if peak > lim:
                raise AssertionError(f"{self.tag}: peak {peak} > {lim} "
                                     "before the rung")
            self.rungs.append({"level": level, "rung": rung, "pass": n,
                               "peak_before": peak, "bound_before": lim,
                               "reserved_before": before,
                               "reserved_after": after})
            self.segments.append((n, sess.schedule, set(ex._pinned)))
            torch.cuda.reset_peak_memory_stats()
            return level

        sess.degrade = watched


def fault_gates(tag, run, watch, want_tokens, skip_rids=()):
    """One faulted run's gates: the tokens of every request not in
    ``skip_rids`` equal ``want_tokens``; the ledger is exact (each pass
    streams its plan's placements under the plan of its time, plus the
    demanded experts and pages); the peak since the last rung (the whole
    run without one) is within the bound of the plan then. Returns the
    row: counters, rungs, peak and bound."""
    sess = run["sess"]
    ex = sess.executor
    for i, (got, want) in enumerate(zip(run["tokens"], want_tokens)):
        if i not in skip_rids and got != want:
            raise AssertionError(f"{tag}: request {i}'s tokens differ from "
                                 "the undisturbed run's")
    by = dict(ex.stats.streamed_bytes_by_dtype)
    want = expected_streamed_by_dtype(ex, watch.segments)
    if ex.stats.demanded_expert_bytes:
        q = next(s.meta["quant"] for s in sess.subs
                 if s.kind == "moe_expert")
        want[q] = want.get(q, 0) + ex.stats.demanded_expert_bytes
    if ex.stats.demanded_page_bytes:
        want["kv"] = ex.stats.demanded_page_bytes
    if by != want or sum(by.values()) != ex.stats.streamed_bytes:
        raise AssertionError(f"{tag}: streamed by dtype {by} != the plans' "
                             f"+ demanded {want}")
    lim, parts = memory_bound(sess,
                              tiers=ex.stats.tiers_used[watch.segments[-1][0]:])
    if run["peak"] > lim:
        raise AssertionError(f"{tag}: peak {run['peak']} > {lim}")
    deg = sess.degradation()
    keys = ("copy_retries", "copy_failures", "worker_crashes",
            "demand_timeouts", "sync_fallbacks", "alloc_failures",
            "degraded_sync")
    row = {k: deg[k] for k in keys}
    row.update({"rung": deg["rung"], "level": deg["level"],
                "rungs": [e["rung"] for e in deg["log"]],
                "fired": deg["injected"]["fired"],
                "streamed_bytes": ex.stats.streamed_bytes,
                "abandoned": (ex.prefetch.stats.abandoned
                              if ex.prefetch is not None else 0),
                "peak": run["peak"], "bound": lim, "wall_s": run["wall"],
                "rung_memory": watch.rungs})
    log(f"{tag}: tokens identical, ledger exact ({ex.stats.streamed_bytes} "
        f"B), peak {'after the rung ' if watch.rungs else ''}{run['peak']} B "
        f"<= bound {lim} B; rung {row['rung']} {row['rungs']}; counters "
        f"{ {k: row[k] for k in keys} }; fired {row['fired']}")
    return row


def faulted(tag, serve, watch, plan_specs):
    """Serve under a FaultPlan of ``plan_specs`` and the default recovery
    policy (real backoff), with the ladder watched, under the wall guard;
    returns the run with its K1 launches."""
    from repro_torch.core import FaultPlan, RecoveryPolicy
    k1 = read_launches()["K1"]
    run = guarded(tag, lambda: serve(faults=FaultPlan(plan_specs),
                                     recovery=RecoveryPolicy(),
                                     on_open=watch))
    run["k1"] = read_launches()["K1"] - k1
    return run


def want_counts(tag, row, **want):
    got = {k: row[k] for k in want}
    if got != want:
        raise AssertionError(f"{tag}: {got} != {want}")


def streamed_key(schedule):
    """A sub-layer the static pool streams in the first pass of the wave
    (the first admission's layer-major prefill): a key whose fault fires
    on the first stagings."""
    pinned = {pl.sub.name for pl in schedule.pinned_placements()}
    tier = schedule.pick_prefill_tier(PROMPT_LEN, min_tier=1)
    return next(p.sub.name for p in
                schedule.tiers[tier].plan.static_stream_order()
                if p.sub.name not in pinned)


def fault_path(cfg, params, db, system, total, base):
    """Phase 14, dense and paged: qwen2-0.5b with phase 3's weights at
    0.1x, 4 x (64 + 16), ``max_batch=4``, under each fault plan, each run
    against phase 3's 0.1x run (``base``: its tokens, streamed bytes and
    K1 launches); then phase 12's 64-page paged run under ``alloc.host``."""
    from repro_torch import Session
    from repro_torch.core import FaultSpec, InferenceSetting, RecoveryPolicy
    budget = int(total * 0.1)
    retries = RecoveryPolicy().max_copy_retries
    key = streamed_key(Session.open(
        cfg, system=system, budget_bytes=budget,
        setting=InferenceSetting(batch=MAX_BATCH, context=MAX_SEQ), db=db,
        max_seq=MAX_SEQ).schedule)
    serve = functools.partial(serve_once, cfg, params, db, system, budget)
    cases = [
        ("empty plan", [], {}),
        ("prefetch.copy fail x2",
         [FaultSpec("prefetch.copy", "fail", count=2)],
         dict(copy_retries=2, copy_failures=0, sync_fallbacks=0)),
        (f"prefetch.copy fail x{retries + 1} on {key}",
         [FaultSpec("prefetch.copy", "fail", count=retries + 1, key=key)],
         dict(copy_retries=retries, copy_failures=1, sync_fallbacks=1)),
        ("prefetch.copy delay 5 ms x8",
         [FaultSpec("prefetch.copy", "delay", delay_s=0.005, count=8)],
         dict(copy_failures=0, sync_fallbacks=0)),
        ("prefetch.worker crash at item 2",
         [FaultSpec("prefetch.worker", "crash", after=1)],
         dict(worker_crashes=1, degraded_sync=True, rung="sync")),
        ("alloc.device oom at decode pass 3",
         [FaultSpec("alloc.device", "oom", key="decode", after=2)],
         dict(alloc_failures=1, rungs=["tier_down"])),
        ("serving.request fail rid 2",
         [FaultSpec("serving.request", "fail", key="2", after=1)],
         dict(rungs=[], level=0)),
    ]
    rows = {}
    reset_launches()
    for name, specs, want in cases:
        tag = f"faults qwen2-0.5b 0.1x, {name}"
        watch = RungWatch(tag)
        run = faulted(tag, serve, watch, specs)
        skip = (2,) if name.startswith("serving.request") else ()
        row = fault_gates(tag, run, watch, base["tokens"], skip)
        want_counts(tag, row, **want)
        row["k1"] = run["k1"]
        if not specs and (run["k1"], row["streamed_bytes"], row["fired"]) \
                != (base["k1"], base["streamed_bytes"], {}):
            raise AssertionError(f"{tag}: K1 {run['k1']} (phase 3: "
                                 f"{base['k1']}), streamed "
                                 f"{row['streamed_bytes']} (phase 3: "
                                 f"{base['streamed_bytes']})")
        if skip:
            reqs, srv = run["reqs"], run["sess"].stats()["serving"]
            if reqs[2].error is None or srv["failed"] != 1 \
                    or len(reqs[2].generated) >= NEW_TOKENS:
                raise AssertionError(f"{tag}: rid 2 did not fail alone: "
                                     f"{srv['failed']} failed")
            row["rid2_tokens_before_error"] = len(reqs[2].generated)
            log(f"  rid 2 failed alone after {len(reqs[2].generated)} "
                "tokens; rids 0, 1, 3 identical to phase 3")
        elif not watch.rungs \
                and row["streamed_bytes"] != base["streamed_bytes"]:
            raise AssertionError(f"{tag}: streamed {row['streamed_bytes']} "
                                 f"!= phase 3's {base['streamed_bytes']}")
        if not specs:
            log(f"  empty plan == phase 3 at 0.1x: tokens, ledger "
                f"({row['streamed_bytes']} B) and K1 launches ({run['k1']})")
        rows[name] = row
        run["sess"].close()
        del run
    counts, variants = read_launches(), read_variants()
    if counts["K1"] <= 0 or variants["K1"] != {"mma": counts["K1"],
                                               "fma": 0} \
            or (counts["K2"], counts["K3"], counts["K4"]) != (0, 0, 0):
        raise AssertionError(f"faults: launches {counts} by kernel "
                             f"{variants}")
    launches = counts["K1"]

    # phase 12's 64-page paged run under an alloc.host fault at a decode
    # pass's page preparation
    tag = f"faults qwen2-0.5b paged {FORCED_POOL} pages 0.1x, alloc.host oom"
    watch = RungWatch(tag)
    reset_launches()
    run = faulted(tag, functools.partial(serve, kv_layout="paged",
                                         kv_pool_pages=FORCED_POOL),
                  watch, [FaultSpec("alloc.host", "oom", after=5)])
    row = fault_gates(tag, run, watch, base["tokens"])
    want_counts(tag, row, rungs=["tier_down"])
    alloc = run["sess"]._batcher.kv.alloc
    alloc.check()
    resident = [b.pid for b in alloc.blocks.values() if b.pid >= 0]
    if len(alloc.free) + len(set(resident)) != alloc.n_pages - 1 \
            or len(resident) != len(set(resident)):
        raise AssertionError(f"{tag}: pool inconsistent")
    log(f"  pool consistent: free {len(alloc.free)} + mapped "
        f"{len(resident)} == pool {alloc.n_pages - 1}, no page mapped "
        "twice")
    counts = read_launches()
    row["k1"] = counts["K1"]
    launches += counts["K1"]
    rows["paged alloc.host"] = row
    run["sess"].close()
    del run
    free_cuda()
    log(f"K1 launches on the faulted qwen2-0.5b runs: {launches}, all mma")
    return {"rows": rows, "launches": launches, "key": key}


def moe_fault_runs(cfg, params, db, system, tot, base_tokens,
                   base_streamed):
    """Phase 14, MoE: phase 11's qwen30b-a3b (its weights and wave),
    granular at 0.1x, under demand faults and an ``alloc.device``. ``db``
    is this phase's own: ``expert_shrink`` re-plans, and a re-plan writes
    the routing EMA into the profile DB, which would move later plans."""
    from repro_torch.core import FaultSpec
    serve = functools.partial(serve_once, cfg, params, db, system,
                              int(tot[True] * 0.1), expert_granular=True)
    cases = [
        ("demand.copy fail x20", [FaultSpec("demand.copy", "fail",
                                            count=20)],
         dict(copy_failures=5, sync_fallbacks=5)),
        ("demand.timeout x1", [FaultSpec("demand.timeout", "timeout")],
         dict(demand_timeouts=1, sync_fallbacks=1, abandoned=1)),
        ("demand.worker crash", [FaultSpec("demand.worker", "crash")],
         dict(worker_crashes=1, degraded_sync=True, rung="sync")),
        ("alloc.device oom at decode pass 3",
         [FaultSpec("alloc.device", "oom", key="decode", after=2)],
         dict(alloc_failures=1, rungs=["expert_shrink"])),
    ]
    rows = {}
    reset_launches()
    for name, specs, want in cases:
        tag = f"faults {MOE_ARCH} granular 0.1x, {name}"
        watch = RungWatch(tag)
        run = faulted(tag, serve, watch, specs)
        row = fault_gates(tag, run, watch, base_tokens)
        want_counts(tag, row, **want)
        if not watch.rungs and row["streamed_bytes"] != base_streamed:
            raise AssertionError(f"{tag}: streamed {row['streamed_bytes']} "
                                 f"!= phase 11's {base_streamed}")
        row["k1"] = run["k1"]
        rows[name] = row
        del run["sess"]
        free_cuda()
    counts = read_launches()
    if counts["K1"] <= 0 or (counts["K2"], counts["K3"], counts["K4"]) \
            != (0, 0, 0):
        raise AssertionError(f"moe faults: launches {counts}")
    log(f"K1 launches on the faulted {MOE_ARCH} runs: {counts['K1']}")
    return {"rows": rows, "launches": counts["K1"]}


def spec_fault_run(cfg, params, db, system, total, draft, plain_tokens):
    """Phase 14, speculative: phase 13's qwen3-14b 0.5x stacked run with
    its qwen2-0.5b draft under an ``alloc.device`` at a verify pass: the
    rung is ``spec_off``, the draft goes and its memory with it."""
    from repro_torch.core import FaultSpec
    tag = f"faults {SPEC_ARCH} spec 0.5x, alloc.device oom at verify 2"
    watch = RungWatch(tag)
    reset_launches()
    run = faulted(tag, functools.partial(
        serve_once, cfg, params, db, system, int(total * 0.5),
        kv_layout="stacked", **draft), watch,
        [FaultSpec("alloc.device", "oom", key="verify", after=1)])
    row = fault_gates(tag, run, watch, plain_tokens)
    want_counts(tag, row, alloc_failures=1, rungs=["spec_off"])
    sess = run["sess"]
    if sess.draft_carve_bytes or sess.spec_active \
            or sess._spec_decoder is not None \
            or sess._batcher.spec is not None:
        raise AssertionError(f"{tag}: the draft survived spec_off")
    row["k1"] = read_launches()["K1"]
    log(f"  spec_off: draft carve 0, draft dropped, tokens == plain greedy; "
        f"K1 launches {row['k1']}")
    sess.close()
    del run
    free_cuda()
    return row


# ------------------------------------------------------------ phase 15
GW_REQ, GW_GAP_S, GW_QUEUE = 8, 0.010, 16


def gateway_wave(vocab):
    """GW_REQ prompts of PROMPT_LEN tokens, NEW_TOKENS each."""
    import numpy as np
    from repro_torch.core.serving import Request
    rng = np.random.RandomState(3)
    return [Request(rid=i, prompt=rng.randint(0, vocab, size=PROMPT_LEN)
                    .astype(np.int32), max_new_tokens=NEW_TOKENS)
            for i in range(GW_REQ)]


def chat_body(cfg, req, stream):
    return json.dumps({"model": cfg.name,
                       "token_ids": [int(t) for t in req.prompt],
                       "max_tokens": req.max_new_tokens,
                       "stream": stream}).encode()


async def sse_request(client, cfg, req, stop_after=None):
    """One streamed chat completion: (tokens, error message or None).
    ``stop_after``: read that many events, then disconnect."""
    from repro_torch.gateway import parse_stream
    st, _, end = await client.open_stream("POST", "/v1/chat/completions",
                                          chat_body(cfg, req, True))
    if st != 200:
        raise AssertionError(f"request {req.rid}: status {st}")
    if stop_after is not None:
        for _ in range(stop_after):
            await end.reader.readuntil(b"\n\n")
        end.close()
        return None, "disconnected"
    raw = await end.reader.read()
    end.close()
    chunks, done = parse_stream(raw)
    err = next((c["error"]["message"] for c in chunks if "error" in c), None)
    toks = [c["choices"][0]["delta"]["token_id"] for c in chunks
            if "choices" in c]
    if err is None and not done:
        raise AssertionError(f"request {req.rid}: stream ended early")
    return toks, err


async def drive_wave(gw, cfg, reqs, during=None):
    """``reqs`` streamed through ``gw``, GW_GAP_S apart; ``during(client)``
    runs once all are sent. Returns ({rid: (tokens, error)}, wall s from
    the first request to the last answer, what ``during`` returned)."""
    from repro_torch.gateway import InprocClient
    c = InprocClient(gw)
    t0 = time.perf_counter()
    tasks = []
    for r in reqs:
        tasks.append(asyncio.ensure_future(sse_request(c, cfg, r)))
        await asyncio.sleep(GW_GAP_S)
    extra = await during(c) if during is not None else None
    res = await asyncio.gather(*tasks)
    return ({r.rid: x for r, x in zip(reqs, res)},
            time.perf_counter() - t0, extra)


def open_session(cfg, params, db, system, budget, **kw):
    from repro_torch import Session
    from repro_torch.core import InferenceSetting
    free_cuda()
    return Session.open(cfg, system=system, budget_bytes=budget,
                        setting=InferenceSetting(batch=MAX_BATCH,
                                                 context=MAX_SEQ),
                        db=db, params=params, max_seq=MAX_SEQ, **kw)


def gateway_path(cfg, params, db, system, total):
    """Phase 15: qwen2-0.5b at 0.1x behind ``Session.gateway`` through
    ``InprocClient``: GW_REQ streamed requests GW_GAP_S apart against a
    direct ``serve`` of the same requests."""
    from repro_torch.core import FaultPlan, FaultSpec, RecoveryPolicy
    from repro_torch.gateway import InprocClient
    budget = int(total * 0.1)
    wave = functools.partial(gateway_wave, cfg.vocab)
    direct = guarded("gateway direct serve", lambda: serve_once(
        cfg, params, db, system, budget, requests=wave))
    want = {r.rid: list(r.generated) for r in direct["reqs"]}
    n_tok = sum(len(t) for t in want.values())
    direct_tps = n_tok / direct["wall"]
    direct_ttft = direct["sess"].stats()["serving"]["mean_ttft_s"]
    direct["sess"].close()
    del direct
    out = {"direct_tps": direct_tps, "direct_mean_ttft_s": direct_ttft,
           "runs": {}}

    def same(tag, got, rids=None):
        for rid in (want if rids is None else rids):
            toks, err = got[rid]
            if err is not None or toks != want[rid]:
                raise AssertionError(f"{tag}: request {rid} got {toks} "
                                     f"({err}), the direct serve "
                                     f"{want[rid]}")

    reset_launches()
    for qa in (True, False):
        tag = f"gateway qwen2-0.5b 0.1x queue_aware={qa}"
        sess = open_session(cfg, params, db, system, budget)

        async def main():
            gw = sess.gateway(max_batch=MAX_BATCH, max_queue=GW_QUEUE,
                              queue_aware=qa).start()
            got, wall, _ = await drive_wave(gw, cfg, wave())
            m = gw.metrics()
            first = (gw._first_chunk_at, gw._first_done_at)
            st, _, b = await InprocClient(gw).request(
                "POST", "/v1/chat/completions", chat_body(cfg, wave()[0],
                                                          False))
            await gw.close(drain=True)
            return got, wall, m, first, st, json.loads(b)

        got, wall, m, (fc, fd), st, unary = guarded(
            tag, lambda: asyncio.run(main()))
        same(tag, got)
        if not (fc is not None and fd is not None and fc < fd):
            raise AssertionError(f"{tag}: first chunk at {fc}, first "
                                 f"completion at {fd}")
        led = m["broker"]["ledger"]
        if not m["broker"]["reconciles"] or led["completed"] != GW_REQ:
            raise AssertionError(f"{tag}: ledger {led}")
        if st != 200 or unary["choices"][0]["token_ids"] != got[0][0]:
            raise AssertionError(f"{tag}: unary {st} != stream")
        tps = n_tok / wall
        row = {"ttft_p50_s": m["ttft_p50_s"], "ttft_p99_s": m["ttft_p99_s"],
               "tps": tps, "wall_s": wall, "ledger": led,
               "first_chunk_before_first_done_s": fd - fc,
               "tiers_used": m["serving"]["tiers_used"]}
        out["runs"][f"queue_aware={qa}"] = row
        log(f"{tag}: SSE tokens == direct serve for {GW_REQ} requests; "
            f"first chunk {fd - fc:.4f} s before the first completion; "
            f"ledger reconciles {led}; unary == stream; tiers "
            f"{row['tiers_used']}")
        log(f"  gateway TTFT p50 {m['ttft_p50_s']:.4f} s, p99 "
            f"{m['ttft_p99_s']:.4f} s; aggregate {tps:.2f} tok/s over the "
            f"gateway against {direct_tps:.2f} tok/s by the direct batcher "
            f"(TTFT mean {direct_ttft:.4f} s)")
        sess.close()
    counts, variants = read_launches(), read_variants()
    if counts["K1"] <= 0 or variants["K1"] != {"mma": counts["K1"],
                                               "fma": 0} \
            or (counts["K2"], counts["K3"], counts["K4"]) != (0, 0, 0):
        raise AssertionError(f"gateway: launches {counts} by kernel "
                             f"{variants}")
    out["launches"] = counts["K1"]
    log(f"K1 launches on the gateway path: {counts['K1']} (by kernel "
        f"{variants['K1']})")

    # a gateway.pump fault: the active tickets fail, the queued ones serve
    tag = "gateway pump fault"
    sess = open_session(cfg, params, db, system, budget,
                        faults=FaultPlan([FaultSpec("gateway.pump", "fail",
                                                    after=4)]),
                        recovery=RecoveryPolicy())

    async def pump_main():
        gw = sess.gateway(max_batch=MAX_BATCH, max_queue=GW_QUEUE).start()
        got, _, _ = await drive_wave(gw, cfg, wave())
        m = gw.metrics()
        await gw.close(drain=True)
        return got, m

    got, m = guarded(tag, lambda: asyncio.run(pump_main()))
    failed = sorted(rid for rid, (_, err) in got.items() if err is not None)
    led = m["broker"]["ledger"]
    if m["pump_errors"] != 1 or not 1 <= len(failed) <= MAX_BATCH \
            or led["failed"] != len(failed) or not m["broker"]["reconciles"]:
        raise AssertionError(f"{tag}: pump errors {m['pump_errors']}, "
                             f"failed {failed}, ledger {led}")
    same(tag, got, [rid for rid in want if rid not in failed])
    for rid in failed:
        toks = got[rid][0]
        if toks != want[rid][:len(toks)]:
            raise AssertionError(f"{tag}: request {rid} streamed other "
                                 "tokens before its error")
    out["pump_fault"] = {"failed": failed, "ledger": led}
    log(f"{tag}: pump_errors 1; requests {failed} (active at the fault) got "
        f"the error, the other {GW_REQ - len(failed)} tokens == direct; "
        "ledger reconciles")
    sess.close()

    # /admin/rebudget 0.1x -> 0.5x once the first chunk has left
    tag = "gateway rebudget 0.1x -> 0.5x"
    sess = open_session(cfg, params, db, system, budget)
    new_budget = int(total * 0.5)

    async def rebudget_main():
        gw = sess.gateway(max_batch=MAX_BATCH, max_queue=GW_QUEUE).start()

        async def rebudget(c):
            while gw._first_chunk_at is None:
                await asyncio.sleep(0.002)
            st, _, b = await c.request(
                "POST", "/admin/rebudget",
                json.dumps({"budget_bytes": new_budget}).encode())
            return st, json.loads(b), gw.batcher.iterations

        got, _, res = await drive_wave(gw, cfg, wave(), during=rebudget)
        await gw.close(drain=True)
        return got, res

    got, (st, obj, at_iter) = guarded(tag,
                                      lambda: asyncio.run(rebudget_main()))
    same(tag, got)
    diff = sess.replan_log[-1]
    ex = sess.executor.stats
    if st != 200 or obj["moved_bytes"] != diff.moved_bytes \
            or (ex.rebind_pinned_bytes, ex.rebind_evicted_bytes) \
            != (diff.pin_bytes, diff.evict_bytes):
        raise AssertionError(f"{tag}: {st} {obj}, diff {diff.summary()}")
    out["rebudget"] = {"moved_bytes": diff.moved_bytes,
                       "pin_bytes": diff.pin_bytes,
                       "at_iteration": at_iter}
    log(f"{tag} at iteration {at_iter}: tokens == direct; moved "
        f"{diff.moved_bytes} B == Schedule.diff (pinned {diff.pin_bytes} "
        f"B)")
    sess.close()

    # the 64-page paged session: a client disconnects mid-stream
    tag = f"gateway paged {FORCED_POOL} pages disconnect"
    sess = open_session(cfg, params, db, system, budget, kv_layout="paged",
                        kv_pool_pages=FORCED_POOL)
    batcher = sess.batcher(max_batch=MAX_BATCH)
    batcher.kv.prefix_enabled = False   # so no block outlives its request

    async def paged_main():
        gw = sess.gateway(max_batch=MAX_BATCH, max_queue=GW_QUEUE).start()
        c = InprocClient(gw)
        reqs = wave()[:MAX_BATCH]
        victim = asyncio.ensure_future(sse_request(c, cfg, reqs[0],
                                                   stop_after=3))
        await asyncio.sleep(GW_GAP_S)
        others = [asyncio.ensure_future(sse_request(c, cfg, r))
                  for r in reqs[1:]]
        await victim
        res = await asyncio.gather(*others)
        m = gw.metrics()
        await gw.close(drain=True)
        return {r.rid: x for r, x in zip(reqs[1:], res)}, m

    got, m = guarded(tag, lambda: asyncio.run(paged_main()))
    same(tag, got, list(got))
    led = m["broker"]["ledger"]
    alloc = batcher.kv.alloc
    alloc.check()
    if led["cancelled"] != 1 or led["completed"] != MAX_BATCH - 1 \
            or any(sl is not None for sl in batcher.slots) \
            or len(alloc.blocks):
        raise AssertionError(f"{tag}: ledger {led}, slots {batcher.slots}, "
                             f"{len(alloc.blocks)} blocks left")
    out["paged_disconnect"] = {"ledger": led,
                               "evictions": batcher.kv.stats.evictions}
    log(f"{tag}: the victim's pages freed (0 blocks left, pool "
        f"consistent), the other {MAX_BATCH - 1} tokens == direct; "
        f"evictions {batcher.kv.stats.evictions}")
    sess.close()

    # /healthz after an injected alloc.device
    tag = "gateway healthz after alloc.device"
    sess = open_session(cfg, params, db, system, budget,
                        faults=FaultPlan([FaultSpec("alloc.device", "oom",
                                                    key="decode", after=1)]),
                        recovery=RecoveryPolicy())

    async def health_main():
        gw = sess.gateway(max_batch=MAX_BATCH, max_queue=GW_QUEUE).start()
        c = InprocClient(gw)
        st, _, b = await c.request("POST", "/v1/chat/completions",
                                   chat_body(cfg, wave()[0], False))
        hst, _, h = await c.request("GET", "/healthz")
        await gw.close(drain=True)
        return st, json.loads(b), hst, json.loads(h)

    st, body, hst, health = guarded(tag, lambda: asyncio.run(health_main()))
    if st != 200 or body["choices"][0]["token_ids"] != want[0] \
            or hst != 200 or health["status"] != "degraded" \
            or health["degradation_rung"] != "tier_down":
        raise AssertionError(f"{tag}: {st}, {hst} {health}")
    out["healthz"] = health
    log(f"{tag}: {health}; tokens == direct")
    sess.close()
    free_cuda()
    return out



# ------------------------------------------------------------ phase 16
FAMILY_ARCHS = ("zamba2-7b", "xlstm-125m", "musicgen-medium")
# the wave: FAMILY_B prompts of PROMPT_LEN tokens (frames for musicgen),
# NEW_TOKENS greedy tokens each
FAMILY_B = 4
# long runs: (prompt, decode steps); the teacher-forced forward covers
# prompt + steps tokens = 4096. zamba2's prompt is 15 SSD chunks (every
# SSD length must be under 256 or a multiple of it)
FAMILY_LONG = {"zamba2-7b": (3840, 256), "musicgen-medium": (4080, 16)}
FAMILY_T = 4096
SSD_ON_CARD = (("zamba2-7b layer", 1, 1024, 112, 64, 64, False),
               ("xlstm-125m mLSTM", 1, 1024, 8, 193, 192, True))
SSD_TOL = 2e-4      # the reference's own (tests/test_ssm.py)
# zamba2's T = 4096 forward through K4 against the same forward with the
# plain attention, in f32: max |diff| within 2e-2 of max |logit|
FLASH_PLAIN_MAX = 2e-2
# families whose bf16 cached path departs from their cache-less forward by
# more than TF_GAP in the reference itself: zamba2's 81 bf16 layers carry
# one rounding flip of the stepped SSD against the chunked one (or of a
# product's f32 sum order) to logit gaps of 0.6 in the JAX package's own
# decode against its own forward (81 layers at d = 256 on the CPU,
# tests/test_torch_families.py::test_zamba2_full_depth_drift). Their
# served tokens are gated in f32 (the bf16 weights cast, f32 KV caches),
# where the same teacher forcing holds to F32_TF_GAP; in bf16 the gap is
# printed
TF_DRIFT_ARCHS = ("zamba2-7b",)
F32_TF_GAP = 1e-2


def family_transient_bytes(cfg, B, T, S):
    """The most a monolithic pass of (B, T) tokens against a cache of S
    positions holds besides the weights and the cache: the logits of all
    T positions (bf16, plus the last row in f32 for the greedy pick) and
    twice the largest one layer's working set (its inputs, outputs and
    intermediates, each counted once: the allocator may keep the previous
    layer's while the next one's are made), plus ``ACT_ALLOWANCE`` for the
    cuBLAS workspace and the allocator's rounding. A layer's working set:
    attention: q, k, v, o and the residual in bf16, the (H, T, S) f32
    scores three times (scores, softmax, mask) and p in bf16, the FFN's
    hidden three times; mamba: its projections (z, xBC, dt), the conv's
    extended input and K products, and the SSD in f32: x, b, c, two
    (H, chunk, chunk) buffers per chunk (segsum and its product, in
    place), y_diag, y_off and the per-chunk states twice; mLSTM: the same
    SSD at its per-head widths plus q, k, v and the up projection; sLSTM:
    the (T, 4d) pre-activations and T f32 state rows."""
    d, V, nq = cfg.d_model, cfg.vocab, max(cfg.n_codebooks, 1)
    rows = B * T
    logits = rows * nq * V * 2 + B * nq * V * 4
    hd, H = cfg.resolved_head_dim, cfg.n_heads
    attn = (rows * (4 * H * hd + d) * 2 + B * H * T * S * (3 * 4 + 2)
            + 3 * rows * max(cfg.d_ff, 1) * 2)

    def ssd(Hh, P, N, per_head):
        c = min(256, T)
        nC = -(-T // c)
        bc = rows * (Hh * N if per_head else N) * 2 * 4
        return (rows * Hh * P * 4 * 3 + bc + 2 * B * nC * Hh * c * c * 4
                + 2 * B * (nC + 1) * Hh * P * N * 4)

    work = attn
    if cfg.family == "hybrid":
        di, n, h = cfg.d_inner, cfg.ssm_state, cfg.n_ssm_heads
        C = di + 2 * n
        mamba = (rows * (di + C + h) * 2 + B * (T + cfg.ssm_conv) * C * 2
                 * (cfg.ssm_conv + 1)
                 + ssd(h, cfg.ssm_head_dim, n, False))
        work = max(attn, mamba)
    elif cfg.family == "ssm":
        di = cfg.ssm_expand * d
        hd_m = cfg.ssm_head_dim
        mlstm = rows * 6 * di * 2 + ssd(di // hd_m, hd_m + 1, hd_m, True)
        slstm = rows * 4 * d * (2 + 4) + rows * d * 4 * 3
        work = max(mlstm, slstm)
    return logits + 2 * work + ACT_ALLOWANCE


def _family_prompts(cfg, gen, B, T):
    import torch
    shape = (B, T, cfg.n_codebooks) if cfg.n_codebooks else (B, T)
    return torch.randint(0, cfg.vocab, shape, generator=gen, device="cuda",
                         dtype=torch.int32)


def _tf_gap(logits, tokens):
    """Largest (top logit - the token's logit) over positions (and
    codebooks): logits (N, [nq,] V), tokens (N, [nq])."""
    import torch
    z = logits.float().reshape(-1, logits.shape[-1])
    t = tokens.reshape(-1).to(torch.int64)
    picked = z.gather(1, t[:, None])[:, 0]
    return (z.max(dim=1).values - picked).max().item()


def greedy_serve(model, params, prompts, steps, max_seq, cache_dtype=None):
    """``Model.prefill`` then ``steps`` greedy ``decode_step``s into a
    fresh cache (its KV in ``cache_dtype`` when given); returns (the
    steps + 1 tokens per sequence (B, steps + 1[, nq]), prefill s, decode
    s, cache bytes)."""
    import torch
    from repro_torch.models.common import greedy_token, tree_nbytes
    B, T = prompts.shape[:2]
    cache = model.init_cache(B, max_seq) if cache_dtype is None else \
        model.impl.init_cache(model.cfg, B, max_seq, dtype=cache_dtype)
    cache_bytes = tree_nbytes(cache)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    last, cache = model.prefill(params, {"tokens": prompts}, cache)
    gen = [greedy_token(last[:, -1])]
    torch.cuda.synchronize()
    t_pre = time.perf_counter() - t0
    t0 = time.perf_counter()
    for s in range(steps):
        logits, cache = model.decode_step(
            params, {"tokens": gen[-1][:, None]}, cache, T + s)
        gen.append(greedy_token(logits[:, -1]))
    torch.cuda.synchronize()
    t_dec = time.perf_counter() - t0
    del cache, last
    return torch.stack(gen, dim=1), t_pre, t_dec, cache_bytes


def family_forward(model, params, tokens):
    """One cache-less forward; returns (logits, seconds, peak bytes)."""
    import torch
    free_cuda()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    logits, _ = model.apply(params, {"tokens": tokens})
    torch.cuda.synchronize()
    return logits, time.perf_counter() - t0, torch.cuda.max_memory_allocated()


def family_wave(arch, cfg, model, params, weight_bytes, gap_limit=TF_GAP,
                cache_dtype=None):
    """FAMILY_B prompts of PROMPT_LEN, NEW_TOKENS greedy tokens each, the
    peak against weights + cache + ``family_transient_bytes`` (bf16); the
    tokens under teacher forcing against a cache-less forward, within
    ``gap_limit`` (printed only when None)."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(3)
    prompts = _family_prompts(cfg, gen, FAMILY_B, PROMPT_LEN)
    S = PROMPT_LEN + NEW_TOKENS
    free_cuda()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    toks, t_pre, t_dec, cache_bytes = greedy_serve(
        model, params, prompts, NEW_TOKENS - 1, S, cache_dtype)
    peak = torch.cuda.max_memory_allocated()
    counts = read_launches()
    if any(counts.values()):
        raise AssertionError(f"{arch} wave: kernel launches {counts} (the "
                             "monolithic path at 64 tokens runs none)")
    allowance = family_transient_bytes(cfg, FAMILY_B, PROMPT_LEN, S)
    bound_b = base + cache_bytes + allowance
    full = torch.cat([prompts, toks[:, :-1]], dim=1)
    logits, _, _ = family_forward(model, params, full)
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"{arch} wave: non-finite forward logits")
    gap = max(_tf_gap(logits[b, PROMPT_LEN - 1:], toks[b])
              for b in range(FAMILY_B))
    del logits
    n_tok = FAMILY_B * (NEW_TOKENS - 1)
    row = {"prefill_s": t_pre, "decode_s": t_dec,
           "decode_tok_s": n_tok / t_dec,
           "decode_steps_s": (NEW_TOKENS - 1) / t_dec,
           "peak": peak, "weights": weight_bytes,
           "baseline_other": base - weight_bytes, "cache": cache_bytes,
           "transient_allowance": allowance, "bound": bound_b,
           "gap_teacher_forced": gap}
    bf16 = cfg.dtype == "bfloat16"
    log(f"{arch} {cfg.dtype} wave of {FAMILY_B} x {PROMPT_LEN} "
        f"{'frames' if cfg.n_codebooks else 'tokens'} + {NEW_TOKENS} new: "
        f"prefill {t_pre:.4f} s, decode {row['decode_tok_s']:.2f} tok/s "
        f"({row['decode_steps_s']:.2f} steps/s); peak {peak} B "
        + (f"<= weights {weight_bytes} + cache {cache_bytes} + transients "
           f"{allowance} (+ {base - weight_bytes} B held before) = "
           f"{bound_b}" if bf16 else "(not gated)")
        + f"; the {FAMILY_B} x {NEW_TOKENS} greedy tokens within {gap:.4f}"
        + (f" <= {gap_limit}" if gap_limit is not None else
           " (printed: see TF_DRIFT_ARCHS)")
        + " of the no-cache forward's top logit under teacher forcing")
    if bf16 and peak > bound_b:
        raise AssertionError(f"{arch} wave: peak {peak} > bound {bound_b}")
    if gap_limit is not None and gap > gap_limit:
        raise AssertionError(f"{arch} {cfg.dtype} wave: teacher-forced gap "
                             f"{gap:.4f} > {gap_limit}")
    return row


def family_long(arch, cfg, model, params):
    """One sequence: prefill + greedy decode to FAMILY_T tokens, and the
    cache-less forward at FAMILY_T through K4 against it (teacher
    forcing; printed only for ``TF_DRIFT_ARCHS``), each K4 launch within
    the bf16-p limit. Returns (results, the FAMILY_T tokens)."""
    import torch
    prompt_len, steps = FAMILY_LONG[arch]
    gen = torch.Generator(device="cuda").manual_seed(4)
    prompt = _family_prompts(cfg, gen, 1, prompt_len)
    free_cuda()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    toks, t_pre, t_dec, _ = greedy_serve(model, params, prompt, steps,
                                         prompt_len + steps)
    peak_serve = torch.cuda.max_memory_allocated()
    if any(read_launches().values()):
        raise AssertionError(f"{arch} long run: kernel launches "
                             f"{read_launches()} in prefill / decode")
    full = torch.cat([prompt, toks[:, :-1]], dim=1)
    assert full.shape[1] == FAMILY_T
    logits, t_fwd, peak_fwd, counts = k4_forward(arch, cfg, model, params,
                                                 full)
    gap = _tf_gap(logits[0, prompt_len - 1:], toks[0])
    gated = arch not in TF_DRIFT_ARCHS
    out = {"prompt": prompt_len, "decode_steps": steps, "prefill_s": t_pre,
           "decode_tok_s": steps / t_dec, "serve_peak": peak_serve,
           "forward_T": FAMILY_T, "forward_s": t_fwd,
           "forward_peak": peak_fwd, "k4_launches": counts["K4"],
           "k4_variants": read_variants()["K4"], "gap_teacher_forced": gap}
    log(f"{arch} long run: prefill {prompt_len} in {t_pre:.4f} s, "
        f"{steps} decode steps {out['decode_tok_s']:.2f} tok/s, peak "
        f"{peak_serve} B; forward at T={FAMILY_T}: K4 launches "
        f"{counts['K4']} (by kernel {out['k4_variants']}), {t_fwd:.4f} s, "
        f"peak {peak_fwd} B; the {steps + 1} greedy tokens within "
        f"{gap:.4f}" + (f" <= {TF_GAP}" if gated else
                        " (printed: see TF_DRIFT_ARCHS)")
        + " of its top logit under teacher forcing")
    if gated and gap > TF_GAP:
        raise AssertionError(f"{arch} long run: teacher-forced gap "
                             f"{gap:.4f} > {TF_GAP}")
    if arch in TF_DRIFT_ARCHS:
        out.update(flash_vs_plain(arch, model, params, full, logits))
    del logits
    layers = layer_excess(lambda: family_forward(model, params, full))
    if len(layers) != counts["K4"] or not max(layers) <= 1.0:
        raise AssertionError(f"{arch} forward: K4 launches at {layers} x "
                             "the bf16-p limit")
    out["k4_p_round_excess"] = max(layers)
    log(f"{arch} forward at T={FAMILY_T}: each of the {counts['K4']} K4 "
        f"launches at most {max(layers):.3f}x the bf16-p limit on its own "
        f"q, k, v (<= 1)")
    free_cuda()
    return out, full


def k4_forward(arch, cfg, model, params, tokens):
    """The cache-less forward at FAMILY_T: one K4 launch per attention
    (the hybrid's shared block per group), on the tensor cores in bf16
    and the CUDA cores in f32, and no other kernel; returns (logits,
    seconds, peak bytes, launches)."""
    import torch
    n_k4 = cfg.n_layers // cfg.shared_attn_every \
        if cfg.family == "hybrid" else cfg.n_layers
    variant = "mma" if cfg.dtype == "bfloat16" else "fma"
    reset_launches()
    logits, t_fwd, peak = family_forward(model, params, tokens)
    counts, variants = read_launches(), read_variants()["K4"]
    want = {name: 0 for name in counts}
    want["K4"] = n_k4
    if counts != want or variants[variant] != n_k4:
        raise AssertionError(f"{arch} {cfg.dtype} forward at "
                             f"T={tokens.shape[1]}: launches {counts} by "
                             f"kernel {variants}, want {want} all {variant}")
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"{arch} forward: non-finite logits")
    return logits, t_fwd, peak, counts


def flash_vs_plain(arch, model, params, tokens, logits):
    """The same forward with ``attend`` on its plain version: no K4
    launch, a peak above the flash forward's; its logits against the K4
    forward's ``logits``, gated in f32 (max |diff| <= FLASH_PLAIN_MAX of
    max |logit|) and printed in bf16 (see TF_DRIFT_ARCHS)."""
    import torch
    from repro_torch.models import attention
    f32 = model.cfg.dtype == "float32"
    peak_fwd = torch.cuda.max_memory_allocated()
    threshold = attention.FLASH_THRESHOLD
    attention.FLASH_THRESHOLD = 1 << 40
    reset_launches()
    try:
        plain, t_plain, peak_plain = family_forward(model, params, tokens)
    finally:
        attention.FLASH_THRESHOLD = threshold
    if read_launches()["K4"] != 0:
        raise AssertionError("plain forward launched K4")
    if peak_fwd >= peak_plain:
        raise AssertionError(f"{arch}: K4 forward peak {peak_fwd} >= plain "
                             f"{peak_plain}")
    mx, rms = encode_gaps(logits, plain)
    del plain
    tag = f"{arch} {model.cfg.dtype} forward at T={tokens.shape[1]}"
    log(f"{tag} with the plain attention: no K4 launch, {t_plain:.4f} s, "
        f"peak {peak_plain} B; K4 against plain logits: max |diff| / max "
        f"|logit| {mx:.3e}" + (f" <= {FLASH_PLAIN_MAX}" if f32 else "")
        + f", rms |diff| / rms |logit| {rms:.3e}"
        + ("" if f32 else " (bf16: printed, see TF_DRIFT_ARCHS)"))
    if f32 and not mx <= FLASH_PLAIN_MAX:
        raise AssertionError(f"{tag}: K4 vs plain logits {mx:.3e} > "
                             f"{FLASH_PLAIN_MAX}")
    return {f"{model.cfg.dtype}_plain_forward_s": t_plain,
            f"{model.cfg.dtype}_plain_forward_peak": peak_plain,
            f"{model.cfg.dtype}_flash_vs_plain_max": mx,
            f"{model.cfg.dtype}_flash_vs_plain_rms": rms}


def family_f32(arch, cfg, params, tokens):
    """``TF_DRIFT_ARCHS``: the bf16 weights cast to f32, served as the
    wave with f32 KV caches and teacher-forced within F32_TF_GAP; the
    FAMILY_T forward through K4 (CUDA cores) against the plain attention's
    within FLASH_PLAIN_MAX. Frees ``params`` (the bf16 tree) on the way."""
    from repro_torch.models import build_model
    from repro_torch.models.common import tree_map, tree_nbytes
    import torch
    cfg32 = cfg.replace(dtype="float32")
    model = build_model(cfg32)
    p32 = tree_map(lambda t: t.float(), params)
    params.clear()
    free_cuda()
    wave = family_wave(arch, cfg32, model, p32, tree_nbytes(p32),
                       gap_limit=F32_TF_GAP, cache_dtype=torch.float32)
    logits, t_fwd, peak, counts = k4_forward(arch, cfg32, model, p32, tokens)
    log(f"{arch} float32 forward at T={tokens.shape[1]}: K4 launches "
        f"{counts['K4']} (by kernel {read_variants()['K4']}), {t_fwd:.4f} "
        f"s, peak {peak} B")
    out = {"wave": wave, "forward_s": t_fwd, "forward_peak": peak,
           **flash_vs_plain(arch, model, p32, tokens, logits)}
    del logits, p32
    free_cuda()
    return out


def ssd_on_card():
    """The SSD scan (``models.ssm.ssd``, f32) at the families' per-layer
    shapes against the sequential recurrence in f64, on the card."""
    import torch
    from repro_torch.device import resolve_device
    from repro_torch.models import ssm
    resolve_device(None)
    gen = torch.Generator(device="cuda").manual_seed(5)
    out = []
    for tag, B, T, H, P, N, per_head in SSD_ON_CARD:
        def rnd(*shape):
            return torch.randn(shape, generator=gen, device="cuda")
        x = rnd(B, T, H, P) * 0.5
        a = -rnd(B, T, H).abs() * 0.3
        b = rnd(*((B, T, H, N) if per_head else (B, T, N))) * 0.5
        c = rnd(*((B, T, H, N) if per_head else (B, T, N))) * 0.5
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        y, S = ssm.ssd(x, a, b, c)
        torch.cuda.synchronize()
        t_ssd = time.perf_counter() - t0
        f64 = torch.float64
        St = torch.zeros((B, H, P, N), dtype=f64, device="cuda")
        ys = []
        for t in range(T):
            # b, c at step t as (B, H or 1, 1, N)
            bt = (b[:, t] if per_head else b[:, t, None]).to(f64)[:, :, None]
            ct = (c[:, t] if per_head else c[:, t, None]).to(f64)[:, :, None]
            St = torch.exp(a[:, t].to(f64))[..., None, None] * St \
                + x[:, t].to(f64)[..., None] * bt
            ys.append((St * ct).sum(-1))
        yr = torch.stack(ys, dim=1)
        errs = []
        for got, ref in ((y, yr), (S, St)):
            err = (got.to(f64) - ref).abs()
            lim = SSD_TOL + SSD_TOL * ref.abs()
            if bool((err > lim).any()) or not bool(torch.isfinite(got).all()):
                raise AssertionError(f"SSD {tag}: max |err| "
                                     f"{err.max().item():.3e} beyond "
                                     f"{SSD_TOL}")
            errs.append(err.max().item())
        out.append({"tag": tag, "shape": [B, T, H, P, N],
                    "per_head": per_head, "max_abs_err_y": errs[0],
                    "max_abs_err_state": errs[1], "seconds": t_ssd})
        log(f"SSD {tag} (B, T, H, P, N) = {(B, T, H, P, N)}, "
            f"{'per-head' if per_head else 'shared'} b/c: against the "
            f"sequential f64 recurrence max |err| y {errs[0]:.3e}, final "
            f"state {errs[1]:.3e} within rtol = atol = {SSD_TOL}; "
            f"{t_ssd:.4f} s")
        del x, a, b, c, y, S, St, ys, yr
    free_cuda()
    return out


def family_planning(link):
    """Each family's full config planned on the h100 at 0.5x its weight
    bytes by a planning-only Session, whose executor raises."""
    from repro_torch import Session
    from repro_torch.configs import get_config
    from repro_torch.core import (SYSTEMS, InferenceSetting, build_graph,
                                  run_install)
    from repro_torch.core.graphing import total_weight_bytes
    system = SYSTEMS["h100"].with_(link_gbps=link)
    db = run_install(system)
    out = {}
    for arch in FAMILY_ARCHS:
        cfg = get_config(arch)
        setting = InferenceSetting(batch=FAMILY_B, context=FAMILY_T)
        budget = total_weight_bytes(build_graph(cfg, wdtype=2)) // 2
        sess = Session.open(cfg, system, budget, setting, db=db)
        est = sess.estimates(FAMILY_T)
        try:
            sess.executor
        except NotImplementedError as e:
            refusal = str(e)
        else:
            raise AssertionError(f"{arch}: the planning-only session "
                                 "built an executor")
        out[arch] = {"sub_layers": len(sess.subs), "budget": budget,
                     "estimates": est}
        log(f"{arch} planning-only session, h100, 0.5x ({budget} B): "
            f"{len(sess.subs)} sub-layers, pinned {est['pinned_bytes']} B, "
            f"est TTFT({FAMILY_T}) {est['ttft_s']:.4f} s, est "
            f"{est['tps']:.2f} tok/s; executor: {refusal}")
    return out


def row_probe():
    """Whether the prefill's ops on the card give a row the same bits
    whatever the chunk's row count: at qwen30b-a3b's widths, rows of a
    64-row chunk against the same rows as a 32-row chunk (prefill tiers
    64 and 32): ``torch.matmul`` at the q, k / v and o projections (bf16),
    the router's logits (K1 in f32), the router's softmax and the gates'
    sum (f32), ``rmsnorm`` over d and per head (qk-norm), and
    ``attention.attend_cached`` for the first and the second 32 rows
    (32/4 heads of 128 against a written cache of 256). Printed (the MoE
    tier item of ROADMAP.md); outside every counted run."""
    import torch
    from repro_torch.kernels.streamed_matmul import streamed_matmul
    from repro_torch.models import attention
    from repro_torch.models.common import rmsnorm
    g = torch.Generator(device="cuda").manual_seed(6)

    def rnd(*shape, scale=1.0, dtype=torch.bfloat16):
        return (torch.randn(shape, generator=g, device="cuda") * scale) \
            .to(dtype)
    x = rnd(64, 2048)
    q, ck, cv = rnd(1, 64, 32, 128), rnd(1, 4, 256, 128), rnd(1, 4, 256, 128)
    w = {n: rnd(k, m, scale=k ** -0.5) for n, (k, m) in
         {"q": (2048, 4096), "kv": (2048, 512), "o": (4096, 2048)}.items()}
    router = rnd(2048, 128, scale=2048 ** -0.5, dtype=torch.float32)
    logits = rnd(64, 128, dtype=torch.float32)
    scale, hscale = rnd(2048), rnd(128)
    ops = {
        "matmul q (2048, 4096)": lambda a: a @ w["q"],
        "matmul k/v (2048, 512)": lambda a: a @ w["kv"],
        "matmul o (4096, 2048)": lambda a: a.repeat(1, 2) @ w["o"],
        "router K1 f32 (2048, 128)": lambda a: streamed_matmul(
            a.float().contiguous(), router),
        "softmax f32 (., 128)": lambda a: torch.softmax(
            logits[:a.shape[0]], dim=-1),
        "gates sum f32 (., 8)": lambda a: torch.softmax(
            logits[:a.shape[0]], dim=-1)[:, :8].sum(-1, keepdim=True),
        "rmsnorm (., 2048)": lambda a: rmsnorm(a, scale, 1e-6),
        "qk-norm (., 32, 128)": lambda a: rmsnorm(
            (a @ w["q"]).reshape(-1, 32, 128), hscale, 1e-6),
    }
    out = {}

    def report(name, full, part):
        diff = int((full != part).sum().item())
        out[name] = diff
        log(f"rows of a 64-row chunk against a 32-row chunk, {name}: "
            f"bit-equal {diff == 0} ({diff} of {part.numel()} elements "
            f"differ, max |diff| "
            f"{(full.float() - part.float()).abs().max().item():.3e})")
    for name, fn in ops.items():
        report(name, fn(x)[:32], fn(x[:32]))
    report("attend_cached rows 0..31",
           attention.attend_cached(q, ck, cv, 0)[:, :32],
           attention.attend_cached(q[:, :32], ck, cv, 0))
    report("attend_cached rows 32..63",
           attention.attend_cached(q, ck, cv, 0)[:, 32:],
           attention.attend_cached(q[:, 32:], ck, cv, 32))
    return out


def families_path(link):
    """Phase 16: zamba2-7b, xlstm-125m and musicgen-medium at full width
    and depth on the card."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.models.common import tree_nbytes
    out = {"ssd": ssd_on_card(), "launches": {}, "variants": {}}
    for arch in FAMILY_ARCHS:
        cfg = get_config(arch)
        model = build_model(cfg)
        free_cuda()
        t0 = time.perf_counter()
        params = model.init(torch.Generator(device="cuda").manual_seed(0))
        torch.cuda.synchronize()
        wbytes = tree_nbytes(params)
        log(f"{arch} ({cfg.family}, {cfg.n_layers} layers, d={cfg.d_model},"
            f" vocab {cfg.vocab}"
            f"{', %d codebooks' % cfg.n_codebooks if cfg.n_codebooks else ''}"
            f"): {wbytes} B of bf16 weights drawn on the card in "
            f"{time.perf_counter() - t0:.1f} s")
        drift = arch in TF_DRIFT_ARCHS
        row = {"weights": wbytes, "wave": family_wave(
            arch, cfg, model, params, wbytes,
            gap_limit=None if drift else TF_GAP)}
        if arch in FAMILY_LONG:
            row["long"], tokens = family_long(arch, cfg, model, params)
            out["launches"][f"{arch} forward_T{FAMILY_T}"] = \
                row["long"]["k4_launches"]
            out["variants"][f"{arch} forward_T{FAMILY_T}"] = \
                row["long"]["k4_variants"]
            if drift:
                row["float32"] = family_f32(arch, cfg, params, tokens)
        out[arch] = row
        del params, model
        free_cuda()
    out["planning"] = family_planning(link)
    out["row_probe"] = row_probe()
    return out



# ------------------------------------------------------------ phase 17
TRAIN_ARCH = "qwen2-0.5b"
TRAIN_B, TRAIN_T, TRAIN_STEPS = 4, 4096, 8
TRAIN_CKPT_EVERY, TRAIN_FAULT = 3, 5
TRAIN_ARGS = ["--arch", TRAIN_ARCH, "--full", "--seq", str(TRAIN_T),
              "--batch", str(TRAIN_B), "--steps", str(TRAIN_STEPS),
              "--remat", "full", "--ckpt-every", str(TRAIN_CKPT_EVERY),
              "--inject-fault", str(TRAIN_FAULT), "--lr", "3e-3",
              "--warmup", "2"]
# the gradient checks against the same step with the plain attention: each
# leaf's relative L2 distance. bf16: both paths round p and every product
# to bf16 at other places, through 24 layers, so K4's bf16 grads are held
# as close to the f32 gradient as the plain attention's bf16 grads are (2x
# their distance plus 2e-2, as tests/test_torch_grads.py holds the port to
# the reference); f32 (the weights cast): the sums' order
GRAD_BF16_MAX = 2e-2
GRAD_F32_MAX = 1e-4
F32_GRAD_LAYERS = 6      # of 24: the plain f32 attention's saved scores
PEAK_GAP_MIN = 20e9      # K4's peak under the plain attention's, B = 1
# bytes a step holds per logit at the loss's peak: the bf16 logits, their
# f32 copy, exp (saved for the backward), the iota mask's f32 select and
# its bool mask (saved), and the backward's f32 and bf16 gradients
LOSS_BYTES_PER_LOGIT = 20
# (arch, layers kept or None, B, T): one remat-none step each at the
# published widths; the plain twin where its saved scores fit
TRAIN_FAMILIES = (("xlstm-125m", None, 4, 512),
                  ("musicgen-medium", None, 1, 4096),
                  ("zamba2-7b", 12, 1, 4096),
                  ("qwen2-vl-7b", 4, 1, 4096),
                  ("qwen30b-a3b", 2, 2, 512))
PLAIN_TWIN = ("zamba2-7b", "qwen2-vl-7b")


def layer_act_bytes(cfg):
    """A layer's saved activations per token at remat none, generously:
    its norms' f32 inputs and outputs and its projections' inputs (48 d),
    the FFN's hidden and the silu's pieces (20 f), and the attention's q,
    k, v, o and their f32 rope copies (24 (H + 2 KV) hd); a mamba layer
    adds its SSD's per-chunk f32 buffers (three of H x chunk floats)."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    f = cfg.moe.d_expert * cfg.moe.top_k if cfg.moe else max(cfg.d_ff, 1)
    out = 48 * d + 20 * f + 24 * (cfg.n_heads + 2 * cfg.n_kv_heads) * hd
    if cfg.family == "hybrid":
        out += 48 * (cfg.d_inner + 2 * cfg.ssm_state) \
            + 3 * 4 * cfg.n_ssm_heads * 256
    return out


def train_peak_bound(cfg, n_params, B, T, remat):
    """The most a train step of (B, T) tokens holds: 14 B a param (bf16
    params and grads, f32 AdamW m and v, and the new bf16 params written
    before the old are freed), the saved activations (remat full: each
    layer's bf16 input; none: ``layer_act_bytes`` a layer), twice one
    layer's activations (its recompute and the backward through it), the
    loss's ``LOSS_BYTES_PER_LOGIT`` a logit, and ``ACT_ALLOWANCE``."""
    rows = B * T
    layer = rows * layer_act_bytes(cfg)
    saved = cfg.n_layers * (rows * cfg.d_model * 2 if remat == "full"
                            else layer)
    logits = rows * max(cfg.n_codebooks, 1) * cfg.vocab
    return (14 * n_params + saved + 2 * layer
            + LOSS_BYTES_PER_LOGIT * logits + ACT_ALLOWANCE)


def _device_batch(batch):
    import torch
    return {k: torch.from_numpy(v).cuda() for k, v in batch.items()}


def _grads_on_card(cfg, params, batch, plain=False):
    """``launch.steps.value_and_grad`` of the remat-none loss, with the
    plain attention when ``plain``; returns (loss, grads, seconds, peak,
    launches, variants), the counts set to 0 just before."""
    import torch
    from repro_torch.launch.steps import make_loss_step, value_and_grad
    from repro_torch.models import attention
    free_cuda()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    threshold = attention.FLASH_THRESHOLD
    if plain:
        attention.FLASH_THRESHOLD = 1 << 40
    try:
        t0 = time.perf_counter()
        loss, grads = value_and_grad(make_loss_step(cfg), params, batch)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    finally:
        attention.FLASH_THRESHOLD = threshold
    return (loss, grads, secs, torch.cuda.max_memory_allocated(),
            read_launches(), read_variants())


def _leaf_gaps(grads, ref):
    """Each leaf's relative L2 distance of ``grads`` from ``ref``."""
    import torch
    from repro_torch.models.common import tree_flatten
    out = []
    for g, r in zip(tree_flatten(grads)[0], tree_flatten(ref)[0]):
        if not bool(torch.isfinite(g).all()):
            raise AssertionError("non-finite gradient")
        rn = r.float().norm().item()
        out.append((g.float() - r.float()).norm().item() / max(rn, 1e-30))
    return out


def _finite(tree, tag):
    import torch
    from repro_torch.models.common import tree_flatten
    if not all(bool(torch.isfinite(t).all()) for t in tree_flatten(tree)[0]):
        raise AssertionError(f"{tag}: non-finite gradient")


def _want_attention(counts, variants, n_fwd, n_bwd, variant, tag):
    """K4 forward ``n_fwd`` and backward ``n_bwd`` launches, all on the
    kernel ``variant``, and no other kernel's."""
    want = {name: 0 for name in counts}
    want.update({"K4": n_fwd, "K4bwd": n_bwd})
    if counts != want or variants["K4"][variant] != n_fwd \
            or variants["K4bwd"][variant] != n_bwd:
        raise AssertionError(f"{tag}: launches {counts} by kernel "
                             f"{variants}, want {want}, forward and "
                             f"backward {variant}")


def train_headline():
    """Phase 17 (a): ``launch.train.main`` on qwen2-0.5b at full width and
    depth, T = 4096, through a fault and its restart."""
    import math
    import shutil
    import statistics
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import train
    from repro_torch.models.common import tree_leaves
    cfg = get_config(TRAIN_ARCH)
    ckpt = ROOT / "build" / "train_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    free_cuda()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    drv = train.main(TRAIN_ARGS + ["--ckpt-dir", str(ckpt)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    counts, variants = read_launches(), read_variants()
    step_secs = drv.step_seconds
    shutil.rmtree(ckpt, ignore_errors=True)
    n_params = sum(t.numel() for t in tree_leaves(drv.state["params"]))
    bound = train_peak_bound(cfg, n_params, TRAIN_B, TRAIN_T, "full")
    log_ = drv.metrics_log
    events = [(s, k) for s, k, _ in drv.events if k != "straggler"]
    restored = (TRAIN_FAULT - 1) // TRAIN_CKPT_EVERY * TRAIN_CKPT_EVERY
    if events != [(TRAIN_FAULT, "fault"), (restored, "restart")]:
        raise AssertionError(f"train events {drv.events}: want one fault "
                             f"at {TRAIN_FAULT}, one restart at {restored}")
    calls = TRAIN_FAULT + TRAIN_STEPS - restored
    if len(log_) != calls or drv.step != TRAIN_STEPS:
        raise AssertionError(f"train log of {len(log_)} steps, want {calls}")
    # the replayed steps (restored .. fault - 1) against their first run
    first = [m["loss"] for m in log_[restored:TRAIN_FAULT]]
    again = [m["loss"] for m in log_[TRAIN_FAULT:2 * TRAIN_FAULT - restored]]
    replay_gap = max(abs(a - b) / abs(a) for a, b in zip(first, again))
    if not replay_gap <= 1e-3 or again != first:
        raise AssertionError(f"replayed steps' losses {again} != {first}")
    traj = [m["loss"] for m in log_[:restored] + log_[TRAIN_FAULT:]]
    if not all(map(math.isfinite, traj)) or \
            not statistics.mean(traj[-3:]) < traj[0]:
        raise AssertionError(f"train losses {traj}: not finite and falling")
    # K4 on every layer: forward twice a step (remat's recompute), backward
    # once, all on the tensor cores (both directions)
    _want_attention(counts, variants, 2 * calls * cfg.n_layers,
                    calls * cfg.n_layers, "mma", "train headline")
    if peak > bound:
        raise AssertionError(f"train peak {peak} > bound {bound}")
    step_s = statistics.median(drv.step_seconds[1:])
    tok_s = TRAIN_B * TRAIN_T / step_s
    log(f"train {TRAIN_ARCH} full width and depth, B={TRAIN_B} T={TRAIN_T}, "
        f"remat full, {TRAIN_STEPS} steps: losses by step "
        f"{[round(x, 4) for x in traj]} (mean of the last 3 "
        f"{statistics.mean(traj[-3:]):.4f} < first {traj[0]:.4f}); fault "
        f"at step {TRAIN_FAULT}, restart from the step-{restored} "
        f"checkpoint, replayed losses {again} against {first} (max "
        f"relative gap {replay_gap:.3e}, bit-equal {again == first})")
    log(f"train {TRAIN_ARCH}: K4 launches forward {counts['K4']} == 2 x "
        f"{calls} step passes x {cfg.n_layers} layers (remat recomputes "
        f"each), backward {counts['K4bwd']} == {calls} x {cfg.n_layers}, "
        f"by kernel {variants['K4']} forward, {variants['K4bwd']} backward; "
        f"step {step_s:.4f} s (median after the "
        f"first), {tok_s:.1f} train tokens/s; peak {peak} B <= bound "
        f"{bound} B ({n_params} params x 14 B + remat's saved inputs + "
        f"the loss's {LOSS_BYTES_PER_LOGIT} B a logit); wall {wall:.1f} s "
        f"with {len(drv.step_seconds)} steps and the checkpoints")
    params = drv.state["params"]
    del drv
    free_cuda()
    return params, {"losses": traj, "replayed": again, "first_run": first,
                    "replay_bit_equal": again == first, "events": events,
                    "step_s": step_s, "tokens_per_s": tok_s,
                    "step_seconds": list(step_secs), "peak": peak,
                    "bound": bound,
                    "n_params": n_params, "wall_s": wall,
                    "k4_launches": counts["K4"],
                    "k4_bwd_launches": counts["K4bwd"],
                    "k4_variants": variants["K4"],
                    "k4_bwd_variants": variants["K4bwd"]}


def check_against_plain(cfg, params, batch, gk, tag):
    """K4's bf16 grads ``gk`` against the same step with the plain
    attention: the plain bf16 grads and, as the reference gradient, K4's
    on the weights cast to f32. Each leaf of ``gk`` must lie as close to
    the f32 gradient as the plain attention's does (2x its distance plus
    ``GRAD_BF16_MAX``). Returns the gaps, peaks, times and the f32 run's
    K4 launches."""
    from repro_torch.models.common import tree_map
    lp, gp, sp, peak_p, counts_p, _ = _grads_on_card(cfg, params, batch,
                                                     plain=True)
    if counts_p["K4"] or counts_p["K4bwd"]:
        raise AssertionError(f"{tag}: the plain twin launched K4")
    p32 = tree_map(lambda t: t.float(), params)
    _, g32, s32, peak32, counts32, variants32 = _grads_on_card(
        cfg.replace(dtype="float32"), p32, batch)
    del p32
    if counts32["K4"] != counts32["K4bwd"] or \
            variants32["K4"]["fma"] != counts32["K4"] or \
            variants32["K4bwd"]["fma"] != counts32["K4bwd"]:
        raise AssertionError(f"{tag} f32: launches {counts32} "
                             f"{variants32}")
    gaps_k, gaps_p = _leaf_gaps(gk, g32), _leaf_gaps(gp, g32)
    gaps = _leaf_gaps(gk, gp)
    del gp, g32
    excess = max(a / (2 * b + GRAD_BF16_MAX) for a, b in zip(gaps_k, gaps_p))
    row = {"loss_plain": float(lp), "leaf_gaps_k4_plain": gaps,
           "leaf_gaps_k4_f32": gaps_k, "leaf_gaps_plain_f32": gaps_p,
           "excess": excess, "s_plain": sp, "s_f32": s32,
           "peak_plain": peak_p, "peak_f32": peak32,
           "f32_k4_launches": counts32["K4"],
           "f32_k4_bwd_launches": counts32["K4bwd"]}
    msg = (f"per-leaf relative L2 from the f32 gradient: K4 max "
           f"{max(gaps_k):.3e}, plain max {max(gaps_p):.3e}, K4 within 2 x "
           f"plain's + {GRAD_BF16_MAX} (max {excess:.3f}x); K4 from plain "
           f"max {max(gaps):.3e}; peak plain {peak_p} B, f32 {peak32} B")
    if not excess <= 1.0:
        raise AssertionError(f"{tag}: {excess:.3f}x the limit (K4 "
                             f"{gaps_k}, plain {gaps_p})")
    free_cuda()
    return row, msg


def train_grad_check(params):
    """Phase 17 (b): B = 1, T = 4096, full depth, remat none: the grads
    through K4 against the same step with the plain attention in bf16
    (``check_against_plain``), K4's peak at least ``PEAK_GAP_MIN`` under
    the plain one's; in f32, over ``F32_GRAD_LAYERS`` layers (the plain
    f32 attention's saved scores), within ``GRAD_F32_MAX``."""
    from repro_torch.configs import get_config
    from repro_torch.data import DataPipeline
    from repro_torch.models.common import tree_map
    cfg = get_config(TRAIN_ARCH)
    batch = _device_batch(DataPipeline(cfg, TRAIN_T, 1, seed=1).batch_at(0))
    lk, gk, sk, peak_k, counts, variants = _grads_on_card(cfg, params, batch)
    _want_attention(counts, variants, cfg.n_layers, cfg.n_layers, "mma",
                    "grad check bfloat16")
    row, msg = check_against_plain(cfg, params, batch, gk, "grad check")
    del gk
    row.update({"layers": cfg.n_layers, "loss_k4": float(lk),
                "k4_launches": counts["K4"],
                "k4_bwd_launches": counts["K4bwd"],
                "k4_variants": variants["K4"], "s_k4": sk,
                "peak_k4": peak_k})
    log(f"grad check {TRAIN_ARCH} bfloat16, {cfg.n_layers} layers, B=1 "
        f"T={TRAIN_T}, remat none: loss {float(lk):.5f} (K4) / "
        f"{row['loss_plain']:.5f} (plain), {sk:.3f} s / "
        f"{row['s_plain']:.3f} s; {msg}; K4 peak {peak_k} B")
    if not row["peak_plain"] - peak_k >= PEAK_GAP_MIN:
        raise AssertionError(f"K4 peak {peak_k} not {PEAK_GAP_MIN:.0f} B "
                             f"under the plain {row['peak_plain']}")
    out = {"bfloat16": row}
    # f32 over F32_GRAD_LAYERS layers: K4 against plain
    c = cfg.replace(dtype="float32", n_layers=F32_GRAD_LAYERS)
    p = {"embed": params["embed"].float(),
         "final_norm": params["final_norm"].float(),
         "layers": tree_map(lambda t: t[:F32_GRAD_LAYERS].float(),
                            params["layers"])}
    lk, gk, sk, peak_k, counts, variants = _grads_on_card(c, p, batch)
    _want_attention(counts, variants, c.n_layers, c.n_layers, "fma",
                    "grad check float32")
    lp, gp, sp, peak_p, counts_p, _ = _grads_on_card(c, p, batch, plain=True)
    gaps = _leaf_gaps(gk, gp)
    del gk, gp, p
    out["float32"] = {
        "layers": c.n_layers, "loss_k4": float(lk), "loss_plain": float(lp),
        "k4_launches": counts["K4"], "k4_bwd_launches": counts["K4bwd"],
        "k4_variants": variants["K4"], "leaf_gaps": gaps, "s_k4": sk,
        "s_plain": sp, "peak_k4": peak_k, "peak_plain": peak_p}
    log(f"grad check {TRAIN_ARCH} float32, {c.n_layers} layers, B=1 "
        f"T={TRAIN_T}, remat none: loss {float(lk):.6f} (K4) / "
        f"{float(lp):.6f} (plain); per-leaf relative L2 max "
        f"{max(gaps):.3e} <= {GRAD_F32_MAX}; {sk:.3f} s / {sp:.3f} s; peak "
        f"{peak_k} B / {peak_p} B")
    if not max(gaps) <= GRAD_F32_MAX:
        raise AssertionError(f"grad check float32: {max(gaps):.3e} > "
                             f"{GRAD_F32_MAX}")
    free_cuda()
    return out


def train_microbatch(params):
    """Phase 17 (c): ``make_train_step(microbatches=2)`` against one pass
    on a batch of 4 x 4096, with tests/test_microbatch.py's tolerances."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import DataPipeline
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.common import tree_flatten
    from repro_torch.optim import OptConfig, adamw_init
    cfg = get_config(TRAIN_ARCH)
    batch = _device_batch(DataPipeline(cfg, TRAIN_T, TRAIN_B, seed=2)
                          .batch_at(0))
    oc = OptConfig(lr=1e-3)
    res = {}
    for n in (1, 2):
        free_cuda()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        p, _, m = make_train_step(cfg, oc=oc, remat="full", microbatches=n)(
            params, adamw_init(oc, params), batch)
        loss = float(m["loss"])
        res[n] = (p, loss, time.perf_counter() - t0,
                  torch.cuda.max_memory_allocated())
    gap = abs(res[1][1] - res[2][1])
    worst = 0.0
    for a, b in zip(tree_flatten(res[1][0])[0], tree_flatten(res[2][0])[0]):
        a, b = a.float(), b.float()
        excess = ((a - b).abs() / (1e-3 + 5e-2 * b.abs())).max().item()
        worst = max(worst, excess)
    log(f"microbatches 2 against 1 ({TRAIN_B} x {TRAIN_T}, remat full): loss "
        f"{res[2][1]:.5f} / {res[1][1]:.5f} (gap {gap:.2e} < 1e-3); params "
        f"within rtol 5e-2, atol 1e-3 (max {worst:.3f}x); step "
        f"{res[2][2]:.3f} s / {res[1][2]:.3f} s; peak {res[2][3]} B / "
        f"{res[1][3]} B")
    if not gap < 1e-3 or not worst <= 1.0:
        raise AssertionError(f"microbatching: loss gap {gap}, params "
                             f"{worst}x the tolerance")
    out = {"loss_1": res[1][1], "loss_2": res[2][1], "params_excess": worst,
           "s_1": res[1][2], "s_2": res[2][2], "peak_1": res[1][3],
           "peak_2": res[2][3]}
    del res
    free_cuda()
    return out


# kernel-name groups of a training step's device time (torch.profiler)
STEP_GROUPS = (("K4 backward dk, dv", ("::dkdv_mma_kernel<",
                                         "::dkdv_kernel<")),
               ("K4 backward rows (D, dq)", ("::rows_mma_kernel<",
                                             "::rows_kernel<")),
               ("K4 forward", (FLASH_MMA, FLASH_FMA)),
               ("cuBLAS products", ("gemm", "Gemm", "sm90_xmma", "cutlass",
                                    "nvjet")))


def train_profile(params):
    """Where a headline training step's time goes: one
    ``make_train_step`` call (B = 4, T = 4096, remat full) under
    ``torch.profiler`` after a warm-up step; device time by kernel group
    (``STEP_GROUPS``, the rest "other kernels") and the busy share of the
    profiled wall."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import DataPipeline
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim import OptConfig, adamw_init
    cfg = get_config(TRAIN_ARCH)
    batch = _device_batch(DataPipeline(cfg, TRAIN_T, TRAIN_B, seed=4)
                          .batch_at(0))
    oc = OptConfig(lr=3e-3, warmup_steps=2, total_steps=TRAIN_STEPS)
    step = make_train_step(cfg, oc=oc, remat="full")
    opt = adamw_init(oc, params)
    free_cuda()
    step(params, opt, batch)      # warm-up
    torch.cuda.synchronize()
    events, wall_us = profiled(lambda: step(params, opt, batch))
    total = kernel_us(events)
    groups = {name: kernel_us(events, names) for name, names in STEP_GROUPS}
    groups["other kernels"] = total - sum(groups.values())
    top = sorted(((e.key, e.self_device_time_total) for e in events
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and not e.key.lower().startswith("memcpy")),
                 key=lambda kv: -kv[1])[:8]
    out = {"wall_ms": wall_us / 1e3, "kernel_ms": total / 1e3,
           "busy_share": total / wall_us,
           "ms_by_group": {k: v / 1e3 for k, v in groups.items()},
           "top": [{"kernel": k[:80], "ms": us / 1e3} for k, us in top]}
    log(f"profile train step {TRAIN_ARCH} B={TRAIN_B} T={TRAIN_T} remat "
        f"full: wall {wall_us / 1e3:.1f} ms (profiled), device kernels "
        f"{total / 1e3:.1f} ms (busy share {total / wall_us:.3f}); "
        + ", ".join(f"{k} {v / 1e3:.1f} ms ({v / max(total, 1):.3f})"
                    for k, v in groups.items()))
    for row in out["top"]:
        log(f"  {row['ms']:.3f} ms  {row['kernel']}")
    del opt
    free_cuda()
    return out


def _family_batch(arch, cfg, B, T):
    """The family's training batch on the card: the synthetic stream, or
    for the vlm phase 9's 1024 vision embeddings, 3072 text tokens and 3D
    positions, with seeded labels and a ``loss_mask`` that leaves the
    vision rows out."""
    import torch
    from repro_torch.data import DataPipeline
    if cfg.family != "vlm":
        return _device_batch(DataPipeline(cfg, T, B, seed=3).batch_at(0))
    batch = _vlm_inputs(cfg)
    g = torch.Generator(device="cuda").manual_seed(4)
    nv = cfg.n_vision_tokens
    S = nv + VLM_TEXT_TOKENS
    batch["labels"] = torch.randint(0, cfg.vocab, (1, S), generator=g,
                                    device="cuda", dtype=torch.int32)
    batch["loss_mask"] = (torch.arange(S, device="cuda") >= nv)[None] \
        .float()
    return batch


def train_families():
    """Phase 17 (d): one remat-none step of each family at its published
    widths (depth cut where stated), grads finite, against the plain
    attention's where its saved scores fit."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.models.common import tree_flatten, tree_leaves
    from repro_torch.optim import OptConfig, adamw_init, adamw_update
    out = {"launches": {}, "bwd_launches": {}, "k1_launches": {},
           "variants": {}}
    for arch, cut, B, T in TRAIN_FAMILIES:
        cfg = get_config(arch)
        full_layers = cfg.n_layers
        if cut:
            cfg = cfg.replace(n_layers=cut)
        free_cuda()
        t0 = time.perf_counter()
        params = build_model(cfg).init(
            torch.Generator(device="cuda").manual_seed(0))
        torch.cuda.synchronize()
        n_params = sum(t.numel() for t in tree_leaves(params))
        log(f"train {arch}: {cfg.n_layers} of {full_layers} layers, "
            f"{n_params} params drawn on the card in "
            f"{time.perf_counter() - t0:.1f} s ({14 * n_params} B at 14 B a "
            f"param)")
        batch = _family_batch(arch, cfg, B, T)
        loss, grads, secs, peak, counts, variants = _grads_on_card(
            cfg, params, batch)
        n_k4 = 0
        if T > 2048:
            n_k4 = cfg.n_layers // cfg.shared_attn_every \
                if cfg.family == "hybrid" else \
                (0 if cfg.family == "ssm" else cfg.n_layers)
        if counts["K4"] != n_k4 or counts["K4bwd"] != n_k4 \
                or variants["K4"]["mma"] != n_k4 \
                or variants["K4bwd"]["mma"] != n_k4 or counts["K2"] \
                or counts["K3"]:
            raise AssertionError(f"train {arch}: launches {counts} "
                                 f"{variants}, want K4 {n_k4} and back")
        if cfg.moe is not None and not (
                variants["K1"]["fma"] == cfg.n_layers
                and variants["K1"]["mma"] > 0
                and variants["K1"]["mma"] % 3 == 0):
            raise AssertionError(f"train {arch}: K1 launches {variants}: "
                                 "want a router call a layer (f32) and 3 "
                                 "an expert call (bf16)")
        _finite(grads, arch)
        row = {"layers": cfg.n_layers, "B": B, "T": T, "params": n_params,
               "loss": float(loss), "s": secs, "peak": peak,
               "k4_launches": counts["K4"], "k4_bwd_launches":
               counts["K4bwd"], "k1_launches": counts["K1"],
               "k1_variants": variants["K1"]}
        msg = (f"train {arch} B={B} T={T} remat none: loss {float(loss):.4f}"
               f", grads finite, {secs:.3f} s, peak {peak} B; K4 "
               f"{counts['K4']} forward / {counts['K4bwd']} backward, K1 "
               f"{counts['K1']} {variants['K1']}")
        if arch in PLAIN_TWIN:
            twin, twin_msg = check_against_plain(cfg, params, batch, grads,
                                                 f"train {arch}")
            row.update(twin)
            msg += f"; {twin_msg}"
        # and the step's AdamW update
        oc = OptConfig()
        new, _, metrics = adamw_update(oc, grads, adamw_init(oc, params),
                                       params)
        if not all(bool(torch.isfinite(t).all())
                   for t in tree_flatten(new)[0]):
            raise AssertionError(f"train {arch}: non-finite update")
        row["grad_norm"] = float(metrics["grad_norm"])
        log(msg + f"; AdamW update finite (grad norm {row['grad_norm']:.4f})")
        out[arch] = row
        out["launches"][arch] = counts["K4"]
        out["bwd_launches"][arch] = counts["K4bwd"]
        out["k1_launches"][arch] = counts["K1"]
        out["variants"][arch] = variants["K4"]
        del params, grads, new, batch
        free_cuda()
    return out


def training_path():
    """Phase 17: training on the card."""
    params, head = train_headline()
    grad = train_grad_check(params)
    micro = train_microbatch(params)
    prof = train_profile(params)
    del params
    free_cuda()
    fam = train_families()
    fwd = {f"{TRAIN_ARCH} train": head["k4_launches"],
           **{f"{TRAIN_ARCH} grad check {dt}": row["k4_launches"]
              for dt, row in grad.items()},
           f"{TRAIN_ARCH} grad check f32 reference":
               grad["bfloat16"]["f32_k4_launches"],
           **{f"{a} train f32 reference": fam[a]["f32_k4_launches"]
              for a in PLAIN_TWIN},
           **{f"{a} train": n for a, n in fam["launches"].items() if n}}
    bwd = {f"{TRAIN_ARCH} train": head["k4_bwd_launches"],
           **{f"{TRAIN_ARCH} grad check {dt}": row["k4_bwd_launches"]
              for dt, row in grad.items()},
           f"{TRAIN_ARCH} grad check f32 reference":
               grad["bfloat16"]["f32_k4_bwd_launches"],
           **{f"{a} train f32 reference": fam[a]["f32_k4_bwd_launches"]
              for a in PLAIN_TWIN},
           **{f"{a} train": n for a, n in fam["bwd_launches"].items()
              if n}}
    return {"headline": head, "grad_check": grad, "microbatch": micro,
            "profile": prof, "families": fam, "k4_by_path": fwd,
            "k4_bwd_by_path": bwd,
            "k1_launches": sum(fam["k1_launches"].values())}



# ------------------------------------------------------------ phase 18: counts
# the counted steps: phase 17's train step, prefill_32k's length at batch 1
# through the cache-less forward (K4 on every layer; the cached prefill
# step holds (B, KV, G, T, S) f32 scores, 60 GB a sequence at 32768
# tokens), and decode_32k's cache at the largest batch of at most 128 whose
# counted peak fits DECODE_FIT_BYTES
COUNT_ARCH = "qwen2-0.5b"
COUNT_PREFILL_T = 32768
COUNT_DECODE_S, COUNT_DECODE_B = 32768, 128
DECODE_FIT_BYTES = 60e9
COUNT_TIMED = 3              # timed runs per step, the median kept
# What the count cannot see of max_memory_allocated: the caching
# allocator rounds each allocation up to 512 B and may hand out a block it
# does not split whole (up to 511 B more in the small pool, 1 MiB in the
# large), which the count bounds storage by storage (``peak_upper_bytes``:
# 1023 B for a storage of at most 1 MiB, 1 MiB + 511 B above); and cuBLAS
# takes a 32 MiB workspace per thread from the allocator the first time a
# thread calls it (the step's thread, and autograd's device thread in a
# backward). The limit: counted temp <= card temp <= counted upper temp +
# 32 MiB x those threads.
CUBLAS_WORKSPACE = 32 * 2 ** 20
# phase 18 (d): the published cells counted on fake tensors on this host
COUNT_CELLS = ((COUNT_ARCH, "train_4k"), (COUNT_ARCH, "prefill_32k"),
               (COUNT_ARCH, "decode_32k"), ("xlstm-125m", "train_4k"),
               ("xlstm-125m", "prefill_32k"), ("xlstm-125m", "decode_32k"),
               ("xlstm-125m", "long_500k"))
COUNT_CELL_WALL_S = 75.0


def start_cell_counts():
    """Phase 18 (d): each of ``COUNT_CELLS`` counted by
    ``python -m repro_torch.launch.dryrun`` in a process of its own, all
    started together; ``finish_cell_counts`` reads them."""
    import os
    env = {**os.environ, "PYTHONPATH": str(SRC), "OMP_NUM_THREADS": "1"}
    procs = []
    for arch, shape in COUNT_CELLS:
        procs.append(((arch, shape), time.perf_counter(), subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             arch, "--shape", shape], cwd=str(ROOT), env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    return procs


def finish_cell_counts(procs):
    """Each cell's record, or why it has none: a cell past
    ``COUNT_CELL_WALL_S`` from its start is stopped (the wall guard)."""
    from repro_torch.launch.dryrun import RESULTS_DIR
    out = {}
    for (arch, shape), t0, p in procs:
        tag = f"{arch} {shape}"
        try:
            if p.poll() is None:
                p.wait(timeout=max(
                    0.0, COUNT_CELL_WALL_S - (time.perf_counter() - t0)))
            _, err = p.communicate()
        except subprocess.TimeoutExpired:
            p.kill()
            p.communicate()
            out[tag] = {"cut_by_wall_guard_s": COUNT_CELL_WALL_S}
            log(f"count {tag}: not counted, cut by the wall guard at "
                f"{COUNT_CELL_WALL_S} s")
            continue
        if p.returncode != 0:
            raise AssertionError(f"count {tag} failed: {err[-2000:]}")
        rec = json.loads((RESULTS_DIR / f"{arch}__{shape}.json").read_text())
        out[tag] = rec
        mem = rec["memory"]
        log(f"count {tag} ({rec['device']}, fake {rec['fake']}): flops "
            f"{rec['flops_per_chip']} (model "
            f"{rec['model_flops_per_chip']:.6e}), bytes "
            f"{rec['bytes_per_chip']}, arguments {mem['argument_bytes']} B, "
            f"per-card peak {mem['per_chip_peak_bytes']} B (fits one card: "
            f"{rec['fits_card']}), kernels {rec['kernels']}, counted in "
            f"{rec['count_seconds']:.1f} s")
    return out


def _real_args(args, gen):
    """Real tensors on the card for a tree of specs: small normal floats
    and token ids under 1000 (a count does not depend on the values)."""
    import torch
    from repro_torch.models.common import tree_map

    def one(t):
        if t.dtype in (torch.int32, torch.int64):
            return torch.randint(0, 1000, t.shape, generator=gen,
                                 device="cuda", dtype=t.dtype)
        return torch.randn(t.shape, generator=gen, device="cuda",
                           dtype=t.dtype).mul_(0.02)
    return tree_map(one, args) if isinstance(args, dict) else one(args)


def counted_step(tag, step, fake_args, call_of):
    """Phase 18 (a), (b): ``step`` counted on fake tensors and on real ones
    on the card. Gates: flops and bytes equal as integers, each K4 and
    K4-backward unit one launch of its wrapper, the card's temp bytes
    within the limit of the counted ones (see ``CUBLAS_WORKSPACE``), and
    the count with the largest storage alive at its peak dropped (a
    planted fault: a saved activation the tracker missed) outside it.
    Then the step's median time over ``COUNT_TIMED`` runs and the achieved
    TFLOP/s (not gated). ``call_of(args)``: the step's call arguments."""
    import statistics
    import torch
    from repro_torch.launch import counting
    from repro_torch.models.common import tree_leaves
    t0 = time.perf_counter()
    with counting.count_step(*fake_args) as fake:
        fake.outputs(step(*call_of(fake_args)))
    fake_s = time.perf_counter() - t0
    gen = torch.Generator(device="cuda").manual_seed(18)
    args = tuple(_real_args(a, gen) for a in fake_args)
    if isinstance(args[1], dict) and "m" in args[1]:    # fresh AdamW state
        for k in ("m", "v"):
            for t in tree_leaves(args[1][k]):
                t.zero_()
        args[1]["step"].zero_()
    free_cuda()
    reset_launches()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    threads = 2 if fake.kernels.get("K4bwd") else 1
    with counting.count_step(*args) as real:
        out = real.outputs(step(*call_of(args)))
        del out
    torch.cuda.synchronize()
    card = torch.cuda.max_memory_allocated() - base
    launches = read_launches()
    for key in ("flops", "bytes_accessed"):
        if getattr(real, key) != getattr(fake, key):
            raise AssertionError(f"{tag}: {key} on the card "
                                 f"{getattr(real, key)} != fake "
                                 f"{getattr(fake, key)}")
    for unit in ("K4", "K4bwd"):
        units = fake.kernels.get(unit, {}).get("units", 0)
        if units != launches[unit] or real.kernels.get(unit, {}).get(
                "units", 0) != units:
            raise AssertionError(f"{tag}: {unit} units {units} against "
                                 f"{launches[unit]} launches")
    pred = fake.peak_live_bytes - fake.argument_bytes
    upper = fake.peak_upper_bytes - fake.argument_bytes \
        + threads * CUBLAS_WORKSPACE
    if not pred <= card <= upper:
        raise AssertionError(f"{tag}: the card's temp bytes {card} outside "
                             f"[{pred}, {upper}] of the count")
    drop, drop_tag = fake.peak_largest
    if pred - drop <= card <= upper - drop - (2 ** 20 + 511):
        raise AssertionError(f"{tag}: planted fault (the {drop} B of "
                             f"{drop_tag} dropped) within the limit")
    times = []
    for _ in range(COUNT_TIMED):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out = step(*call_of(args))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t1)
        del out
    step_s = statistics.median(times)
    tflops = fake.flops / step_s / 1e12
    share = fake.flops / step_s / counting.PEAK_BF16_FLOPS
    log(f"count {tag}: flops {fake.flops} == on the card, bytes "
        f"{fake.bytes_accessed} == on the card, peak live "
        f"{fake.peak_live_bytes} B (on the card's count "
        f"{real.peak_live_bytes}); kernels {fake.kernels} == launches "
        f"{ {k: v for k, v in launches.items() if v} }; temp bytes: counted "
        f"{pred} <= card {card} <= {upper} (+{card - pred} B); planted "
        f"fault, the {drop} B of {drop_tag} alive at the peak dropped: "
        f"{pred - drop} outside; fake count {fake_s:.1f} s on the host")
    log(f"count {tag}: step {step_s:.4f} s (median of {COUNT_TIMED}), "
        f"{tflops:.2f} TFLOP/s achieved = {share:.4f} of the bf16 peak "
        f"(989 TFLOP/s)")
    rec = {"flops": fake.flops, "bytes": fake.bytes_accessed,
           "peak_live_bytes": fake.peak_live_bytes,
           "card_peak_live_bytes": real.peak_live_bytes,
           "argument_bytes": fake.argument_bytes, "temp_counted": pred,
           "temp_card": card, "temp_upper": upper,
           "planted_fault": {"dropped": drop, "tag": drop_tag},
           "kernels": fake.kernels, "launches": launches,
           "fake_count_s": fake_s, "step_s": step_s, "times": times,
           "tflops": tflops, "peak_share": share}
    del args
    free_cuda()
    return rec


def counting_path():
    """Phase 18: the counts of ``launch/counting.py`` on the card; no
    process of (d) outlives it."""
    procs = start_cell_counts()
    try:
        return _counting_path(procs)
    finally:
        for _, _, p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()


def _counting_path(procs):
    import torch
    from repro_torch.config import ShapeConfig
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun
    from repro_torch.models.api import build_model, input_specs, param_specs
    cfg = get_config(COUNT_ARCH)
    out = {}
    # (a) phase 17's train step, remat full
    shape = ShapeConfig("phase18_train", "train", TRAIN_T, TRAIN_B)
    step, args, _, _, _ = dryrun.build_cell(cfg, shape, "cuda", COUNT_ARCH)
    out["train"] = counted_step(f"train {COUNT_ARCH} B={TRAIN_B} "
                                f"T={TRAIN_T} remat full", step, args,
                                lambda a: a)
    # (b) prefill_32k's length at batch 1: the cache-less forward
    model = build_model(cfg)
    shape = ShapeConfig("phase18_prefill", "prefill", COUNT_PREFILL_T, 1)
    fargs = (param_specs(cfg, "cuda"),
             {"tokens": input_specs(cfg, shape, "cuda")["batch"]["tokens"]})
    with torch.no_grad():
        out["prefill"] = counted_step(
            f"prefill {COUNT_ARCH} B=1 T={COUNT_PREFILL_T} (cache-less "
            "forward, K4)", lambda p, b: model.apply(p, b)[0], fargs,
            lambda a: a)
        # decode_32k's cache at the largest batch that fits
        B = COUNT_DECODE_B
        while True:
            shape = ShapeConfig("phase18_decode", "decode", COUNT_DECODE_S, B)
            step, args, _, _, _ = dryrun.build_cell(cfg, shape, "cuda")
            peak = dryrun.count_cell(COUNT_ARCH, shape, "cuda")[0] \
                .peak_live_bytes
            if peak <= DECODE_FIT_BYTES or B == 1:
                break
            B //= 2
        out["decode"] = counted_step(
            f"decode {COUNT_ARCH} B={B} S={COUNT_DECODE_S}", step, args,
            lambda a: a[:3] + (COUNT_DECODE_S - 1,))
        out["decode"]["batch"] = B
    out["cells"] = finish_cell_counts(procs)
    return out


# ------------------------------------------------------------ phase 19
# the examples' twins (``examples/*_torch.py``), each ``main`` called in
# process on the card, on this thread, under a wall guard
EXAMPLES_ARCH = "qwen2-0.5b"
EXAMPLES_WALL_S = 300.0
# vlm_budget's encoder: N = 256 patches, 2 layers, one K4 launch per layer
# and Q-chunk of 32, 64 and 128 rows
EXAMPLES_VLM_LAUNCHES = (256 // 32 + 256 // 64 + 256 // 128) * 2
EXAMPLES_TRAIN_B, EXAMPLES_TRAIN_T = 2, 4096
EXAMPLES_TRAIN_STEPS, EXAMPLES_TRAIN_FAULT = 30, 25
EXAMPLES_TRAIN_CKPT_EVERY = 20            # train_lm's own
EXAMPLES_TRAIN_ARGS = ["--preset", "100m", "--seq", str(EXAMPLES_TRAIN_T),
                       "--batch", str(EXAMPLES_TRAIN_B),
                       "--steps", str(EXAMPLES_TRAIN_STEPS),
                       "--inject-fault", str(EXAMPLES_TRAIN_FAULT)]


def load_example(name):
    """``examples/<name>.py`` as a module (``examples/`` is no package)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        f"example_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_example(name, argv, twin=None):
    """``examples/<name>.py``'s ``main(argv)`` (``twin``: the module,
    already loaded) under a wall guard, with every kernel's count set to
    0 just before and read just after: (its result, launches, launches by
    kernel variant, seconds)."""
    import torch
    twin = twin or load_example(name)
    free_cuda()
    reset_launches()
    t0 = time.perf_counter()
    res = guarded(f"examples {name}", lambda: twin.main(argv),
                  seconds=EXAMPLES_WALL_S)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts, variants = read_launches(), read_variants()
    log(f"examples {name} {' '.join(argv)}: {secs:.1f} s, launches "
        f"{counts}, by kernel {variants}")
    return res, counts, variants, secs


def watched_session(peaks):
    """A ``Session`` whose ``serve`` keeps, in ``peaks``, one entry per
    session: its own device peak against ``memory_bound``, read after each
    serve made before any re-plan. The peak is reset at the session's
    first serve, once the collector has freed the session before; what is
    allocated then belongs to no session (the earlier phases leave, among
    other things, the cuBLAS workspace of autograd's thread), so the
    session's own peak is ``max_memory_allocated`` less it, as phase 18
    counts a step's temporary bytes."""
    import torch
    from repro_torch import Session

    class Watched(Session):
        def serve(self, requests, **kw):
            if not hasattr(self, "_peak_index"):
                self._peak_index = len(peaks)
                peaks.append(None)
                free_cuda()
                torch.cuda.reset_peak_memory_stats()
                self._allocated_before = torch.cuda.memory_allocated()
            out = super().serve(requests, **kw)
            if not self.replan_log:
                torch.cuda.synchronize()
                lim, parts = memory_bound(self)
                raw = torch.cuda.max_memory_allocated()
                peaks[self._peak_index] = {
                    "budget_bytes": self.budget_bytes,
                    "before": self._allocated_before, "peak_raw": raw,
                    "peak": raw - self._allocated_before,
                    "bound": lim, "parts": parts}
            return out
    return Watched


def _want_k1(tag, counts, variants, mma_only):
    """K1 launched (all on the tensor cores with ``mma_only``), and no
    other kernel."""
    others = {k: n for k, n in counts.items() if k != "K1" and n}
    if counts["K1"] <= 0 or others:
        raise AssertionError(f"{tag}: launches {counts}, want K1 only")
    if mma_only and variants["K1"] != {"mma": counts["K1"], "fma": 0}:
        raise AssertionError(f"{tag}: K1 by kernel {variants['K1']}, not "
                             "all on the tensor cores")


# the sessions serve_vram_budget serves from: one per budget, then the
# live re-budget's until its re-plan
EXAMPLES_PEAK_TAGS = ("2.0x", "0.5x", "0.1x", "2.0x before the re-budget")


def examples_serve_vram_budget(out):
    """serve_vram_budget_torch at qwen2-0.5b's published config (peaks
    gated) and at its default, qwen30b-a3b's smoke config."""
    name = "serve_vram_budget_torch"
    for argv, full in ((["--arch", EXAMPLES_ARCH, "--full"], True),
                       ([], False)):
        twin = load_example(name)
        peaks = []
        if full:
            twin.Session = watched_session(peaks)
        res, counts, variants, secs = run_example(name, argv, twin)
        tag = f"{name} {res['arch']}"
        rows = res["rows"]
        for row in rows:
            if not row["identical"]:
                raise AssertionError(f"{tag} {row['budget']}x: tokens "
                                     "differ from 2.0x")
        if not rows[-1]["streamed_bytes"] > 0:
            raise AssertionError(f"{tag}: nothing streamed at 0.1x")
        if not res["rebudget"]["identical"]:
            raise AssertionError(f"{tag}: the live re-budget changed the "
                                 "tokens")
        log(f"{tag}: tokens identical across budgets 2.0x, 0.5x, 0.1x: "
            "True")
        log(f"{tag}: streamed at 0.1x {rows[-1]['streamed_bytes']} B > 0")
        log(f"{tag}: live rebudget 2.0x -> 0.1x moved "
            f"{res['rebudget']['moved_bytes']} B "
            f"({res['rebudget']['summary']}), remaining tokens identical "
            "to uninterrupted runs: True")
        _want_k1(tag, counts, variants, mma_only=full)
        if full:
            if len(peaks) != len(EXAMPLES_PEAK_TAGS) or None in peaks:
                raise AssertionError(f"{tag}: peaks {peaks}, want one per "
                                     f"session {EXAMPLES_PEAK_TAGS}")
            for when, b in zip(EXAMPLES_PEAK_TAGS, peaks):
                log(f"{tag} {when}: peak device memory {b['peak_raw']} B "
                    f"less {b['before']} B allocated before the session = "
                    f"{b['peak']} B <= bound {b['bound']} B {b['parts']}")
                if b["peak"] > b["bound"]:
                    raise AssertionError(f"{tag} {when}: peak {b['peak']} "
                                         f"> {b['bound']}")
        log(f"{tag}: K1 launches {counts['K1']} (by kernel "
            f"{variants['K1']})")
        out[tag] = {
            "rows": [{k: r[k] for k in ("budget", "served_s",
                                        "streamed_bytes", "engine_calls",
                                        "identical")} for r in rows],
            "rebudget": {k: res["rebudget"][k] for k in (
                "moved_bytes", "summary", "identical")},
            "peaks": [{k: b[k] for k in ("budget_bytes", "before",
                                         "peak_raw", "peak", "bound")}
                      for b in peaks],
            "launches": counts, "variants": variants, "seconds": secs}


def examples_quickstart(out):
    res, counts, variants, secs = run_example(
        "quickstart_torch", ["--arch", EXAMPLES_ARCH, "--full"])
    tag = f"quickstart_torch {EXAMPLES_ARCH}"
    if not res["identical"]:
        raise AssertionError(f"{tag}: tokens differ across budgets")
    _want_k1(tag, counts, variants, mma_only=True)
    log(f"{tag} full width: tokens identical across budgets: True "
        f"(2.0x -> 0.1x moved {res['moved_bytes']} B, {res['summary']}; "
        f"sample {res['generated'][0]})")
    log(f"{tag}: K1 launches {counts['K1']} (by kernel {variants['K1']})")
    out[tag] = {"identical": True, "moved_bytes": res["moved_bytes"],
                "summary": res["summary"], "generated": res["generated"],
                "launches": counts, "variants": variants, "seconds": secs}


def examples_serve_http(out):
    res, counts, variants, secs = run_example(
        "serve_http_torch", ["--arch", EXAMPLES_ARCH, "--full", "--port",
                             "0"])
    tag = f"serve_http_torch {EXAMPLES_ARCH}"
    # the twin raises itself when stream != unary or the in-flight tokens
    # moved across the re-budget; checked again from what it returned
    if res["stream_tokens"] != res["unary_tokens"] or \
            res["inflight_tokens"] != res["baseline_tokens"]:
        raise AssertionError(f"{tag}: stream {res['stream_tokens']} unary "
                             f"{res['unary_tokens']} in flight "
                             f"{res['inflight_tokens']} baseline "
                             f"{res['baseline_tokens']}")
    if res["completed"] != 4 or not res["reconciles"]:
        raise AssertionError(f"{tag}: /metrics completed "
                             f"{res['completed']}, reconciles "
                             f"{res['reconciles']}")
    _want_k1(tag, counts, variants, mma_only=True)
    log(f"{tag} full width over a socket: stream == unary "
        f"{res['stream_tokens']}")
    log(f"{tag}: in-flight == baseline across /admin/rebudget "
        f"({res['rebudget']['summary']}): {res['inflight_tokens']}")
    log(f"{tag}: /metrics completed 4, reconciles True, ttft_p50 "
        f"{res['ttft_p50_s']:.4f} s")
    log(f"{tag}: K1 launches {counts['K1']} (by kernel {variants['K1']})")
    out[tag] = {k: res[k] for k in ("stream_tokens", "inflight_tokens",
                                    "completed", "reconciles",
                                    "ttft_p50_s")}
    out[tag].update({"rebudget": res["rebudget"]["summary"],
                     "launches": counts, "variants": variants,
                     "seconds": secs})


def examples_vlm_budget(out):
    res, counts, variants, secs = run_example("vlm_budget_torch", [])
    tag = "vlm_budget_torch"
    atol = TOL["float32"]["atol"]
    for f in res["flash"]:
        if not f["max_err"] <= atol:
            raise AssertionError(f"{tag} q_chunk {f['q_chunk']}: max err "
                                 f"{f['max_err']} > {atol}")
    want = {name: 0 for name in counts}
    want["K4"] = EXAMPLES_VLM_LAUNCHES
    if counts != want or variants["K4"] != {"mma": 0,
                                            "fma": EXAMPLES_VLM_LAUNCHES}:
        raise AssertionError(f"{tag}: launches {counts} by kernel "
                             f"{variants}, want {EXAMPLES_VLM_LAUNCHES} K4 "
                             "on fma")
    # the grid, the reduction and the plans are analytic: the card's run
    # prints what the host's does
    cpu = guarded(f"examples {tag} --device cpu",
                  lambda: load_example(tag).main(["--device", "cpu"]),
                  seconds=EXAMPLES_WALL_S)
    for key in ("grid", "reduction", "plans"):
        if res[key] != cpu[key]:
            raise AssertionError(f"{tag}: {key} on the card {res[key]} != "
                                 f"on the CPU {cpu[key]}")
    log(f"{tag}: flash vs plain f32 encoder max |err| "
        f"{[f['max_err'] for f in res['flash']]} at q_chunk 32, 64, 128, "
        f"each <= atol {atol} (f32 K4 tolerance rtol "
        f"{TOL['float32']['rtol']} / atol {atol}, taken at its atol)")
    log(f"{tag}: K4 launches {counts['K4']} == (256/32 + 256/64 + "
        f"256/128) x 2 layers (by kernel {variants['K4']})")
    log(f"{tag}: grid, 1440p reduction {res['reduction']:.1f}x and plans "
        "equal to the CPU run's: True")
    out[tag] = {"flash": res["flash"], "reduction": res["reduction"],
                "plans": res["plans"], "launches": counts,
                "variants": variants, "seconds": secs}


def examples_train_lm(out):
    import math
    import shutil
    import statistics
    name = "train_lm_torch"
    twin = load_example(name)
    n_layers = twin.preset_cfg("100m").n_layers
    ckpt = ROOT / "build" / "examples_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    try:
        res, counts, variants, secs = run_example(
            name, EXAMPLES_TRAIN_ARGS + ["--ckpt-dir", str(ckpt)], twin)
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    tag = f"{name} {res['arch']}"
    fault, steps = EXAMPLES_TRAIN_FAULT, EXAMPLES_TRAIN_STEPS
    restored = (fault - 1) // EXAMPLES_TRAIN_CKPT_EVERY \
        * EXAMPLES_TRAIN_CKPT_EVERY
    events = [(s, k) for s, k, _ in res["events"] if k != "straggler"]
    if events != [(fault, "fault"), (restored, "restart")]:
        raise AssertionError(f"{tag}: events {res['events']}, want a fault "
                             f"at {fault} and a restart at {restored}")
    losses = [m["loss"] for m in res["log"]]
    passes = fault + steps - restored
    if len(losses) != passes or res["steps"] != steps:
        raise AssertionError(f"{tag}: {len(losses)} step passes, want "
                             f"{passes}")
    first, again = losses[restored:fault], losses[fault:2 * fault - restored]
    if again != first:
        raise AssertionError(f"{tag}: replayed losses {again} != first "
                             f"pass {first}")
    if not all(map(math.isfinite, losses)) or \
            not statistics.mean(losses[-3:]) < losses[0]:
        raise AssertionError(f"{tag}: losses {losses} not finite and "
                             "falling")
    _want_attention(counts, variants, passes * n_layers, passes * n_layers,
                    "mma", tag)
    step_s = statistics.median(res["step_seconds"][1:])
    tokens = EXAMPLES_TRAIN_B * EXAMPLES_TRAIN_T
    stragglers = [e for e in res["events"] if e[1] == "straggler"]
    log(f"{tag} B={EXAMPLES_TRAIN_B} T={EXAMPLES_TRAIN_T}: events {events} "
        f"== one fault at {fault}, one restart at {restored} (stragglers, "
        f"not gated: {stragglers})")
    log(f"{tag}: replayed steps {restored}-{fault - 1} losses {again} "
        "bit-equal to the first pass: True")
    log(f"{tag}: loss {losses[0]:.4f} -> mean of the last 3 "
        f"{statistics.mean(losses[-3:]):.4f} < first")
    log(f"{tag}: K4 launches forward {counts['K4']} == backward "
        f"{counts['K4bwd']} == {passes} step passes x {n_layers} layers "
        f"(by kernel {variants['K4']} forward, {variants['K4bwd']} "
        "backward)")
    log(f"{tag}: step {step_s:.4f} s (median after the first), "
        f"{tokens / step_s:.1f} train tokens/s")
    out[tag] = {"losses": losses, "replayed": again, "events": events,
                "stragglers": stragglers, "tokens_per_s": tokens / step_s,
                "n_params": res["n_params"], "step_s": step_s,
                "launches": counts, "variants": variants, "seconds": secs}


def examples_path():
    """Phase 19: the five examples' twins at full width where they have
    ``--full``: serve_vram_budget (and at its default arch), quickstart,
    serve_http, vlm_budget and train_lm."""
    out = {}
    examples_serve_vram_budget(out)
    examples_quickstart(out)
    examples_serve_http(out)
    examples_vlm_budget(out)
    examples_train_lm(out)
    free_cuda()
    k1 = {f"examples: {tag}": row["launches"]["K1"]
          for tag, row in out.items() if row["launches"]["K1"]}
    k4 = {f"examples: {tag}": row["launches"]["K4"]
          for tag, row in out.items() if row["launches"]["K4"]}
    k4b = {f"examples: {tag}": row["launches"]["K4bwd"]
           for tag, row in out.items() if row["launches"]["K4bwd"]}
    return {"twins": out, "k1_by_path": k1, "k4_by_path": k4,
            "k4_bwd_by_path": k4b}


GRAPH_SEQ = 160


def _graph_session(model, device):
    """A resident session (2.0x) of a benchmark configuration cut to a
    few layers at its published widths, weights drawn on ``device``:
    qwen3-14b at 2 layers, or Nemotron-H at 3 (``M*-``). Returns it and
    its vocabulary."""
    from repro_torch import Session
    from repro_torch.core import (SYSTEMS, InferenceSetting, build_graph,
                                  run_install, total_weight_bytes)
    sys.path.insert(0, str(ROOT))
    from portbench import spec
    from portbench.weights import draw_weights
    if model == "qwen3-14b":
        c = json.loads((ROOT / "portbench/configs/qwen3-14b-10of40.json")
                       .read_text())
        c["num_hidden_layers"] = 2
    else:
        c = json.loads((ROOT / "portbench/configs/"
                        "nemotron-h-47b-19of98.json").read_text())
        c.update(num_hidden_layers=3, hybrid_override_pattern="M*-")
    arch = spec.architecture(c)
    s = arch.shapes(c, model)
    cfg = arch.port_config(c, s)
    host = draw_weights(arch.leaves(s), 2 ** 31 + 32, device)
    system = SYSTEMS["h100"]
    total = total_weight_bytes(build_graph(cfg))
    return Session.open(cfg, system, 2 * total,
                        InferenceSetting(batch=MAX_BATCH, context=GRAPH_SEQ),
                        db=run_install(system, quick=True), params=host,
                        max_seq=GRAPH_SEQ, device=device), s.vocab


def graphed_against_eager(ex, vocab, steps, seed=0):
    """``steps`` fused passes of ``ex`` through ``decode_fused`` on a
    fresh cache, and as many eager ``_run_decode`` passes on a copy of
    it, with the same inputs: each step's active slots (every count from
    1 to MAX_BATCH in the first steps, then drawn) at their own
    positions. Raises unless every step's logits and tokens are
    ``torch.equal`` and the caches equal after. Returns the decode tiers
    the steps ran at."""
    import numpy as np
    import torch
    from repro_torch.models.common import greedy_token
    dev = ex.device
    rng = np.random.RandomState(seed)
    lens = rng.randint(8, 25, size=MAX_BATCH)
    kv = ex.init_kv(MAX_BATCH)
    for slot, n in enumerate(lens):
        ex.prefill(torch.as_tensor(rng.randint(0, vocab, size=(1, n))
                                   .astype(np.int32)), kv=kv, slot=slot)
    copy = {k: v.clone() for k, v in kv.items()}
    pos = lens.astype(np.int32)
    tiers = []
    for step in range(steps):
        n = 1 + (step % MAX_BATCH if step < 2 * MAX_BATCH
                 else rng.randint(MAX_BATCH))
        act = np.zeros(MAX_BATCH, bool)
        act[rng.choice(MAX_BATCH, n, replace=False)] = True
        tok = rng.randint(0, vocab, size=(MAX_BATCH, 1)).astype(np.int32)
        args = [torch.as_tensor(a).to(dev) for a in (tok, pos, act)]
        lg, _, tg = ex.decode_fused(args[0], kv, args[1], args[2], n,
                                    pick=greedy_token)
        le, _ = ex._run_decode(args[0], copy, args[1], args[2], n)
        if not (torch.equal(lg, le) and torch.equal(tg,
                                                    greedy_token(le[:, -1]))):
            gap = (lg.float() - le.float()).abs().max().item()
            raise AssertionError(f"step {step} ({n} active): graphed logits "
                                 f"!= eager (max |diff| {gap})")
        tiers.append(ex._decode_tier(n))
        pos = pos + act
    for k in kv:
        if not torch.equal(kv[k], copy[k]):
            raise AssertionError(f"the graphed steps left another {k!r} "
                                 "than the eager ones")
    return tiers


def _ms_per_step(fn, steps=20):
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / steps


def decode_graph_check(model, device, steps=100):
    """Graphed decode against eager for one model (``_graph_session``):
    first 16 steps at the tiers the card's own profile picks (one for 1
    to 4 new tokens), then ``steps`` more on a new cache with each count
    of active slots forced to one of the first four tiers of the table,
    the eager pass and the graphed one alike; each cache recorded once
    per tier and replayed after; one more recording after a rebind; and
    K1 launched by its wrapper on every graphed pass. Returns what it
    read: tiers, recordings, replays, and a graphed and an eager step's
    host ms at every slot active."""
    import torch
    from repro_torch.kernels.streamed_matmul import streamed_matmul
    from repro_torch.models.common import greedy_token
    sess, vocab = _graph_session(model, device)
    ex = sess.executor
    st = ex.stats
    own = graphed_against_eager(ex, vocab, 16, seed=1)
    if st.decode_graph_captures != len(set(own)):
        raise AssertionError(f"{st.decode_graph_captures} recordings at the "
                             f"card's own tiers {sorted(set(own))}")
    first = sorted(ex.schedule.tiers)[:MAX_BATCH]
    ex._decode_tier = lambda n: first[n - 1]
    try:
        tiers = graphed_against_eager(ex, vocab, steps)
    finally:
        del ex._decode_tier
    made = st.decode_graph_captures - len(set(own))
    if made != len(set(tiers)) or len(set(tiers)) < 2:
        raise AssertionError(f"{made} recordings at the tiers "
                             f"{sorted(set(tiers))}")
    if st.decode_graph_replays != 16 + steps - st.decode_graph_captures:
        raise AssertionError(f"{st.decode_graph_replays} replays of "
                             f"{16 + steps} steps")
    ex.rebind(ex.schedule)
    kv = ex.init_kv(MAX_BATCH)
    args = (torch.zeros((MAX_BATCH, 1), dtype=torch.int32, device=device),
            kv, torch.full((MAX_BATCH,), 8, dtype=torch.int32,
                           device=device),
            torch.ones(MAX_BATCH, dtype=torch.bool, device=device),
            MAX_BATCH)
    before = st.decode_graph_captures
    ex.decode_fused(*args, pick=greedy_token)
    k1 = streamed_matmul.launches
    graphed = _ms_per_step(lambda: ex.decode_fused(*args, pick=greedy_token))
    k1 = streamed_matmul.launches - k1
    if st.decode_graph_captures != before + 1:
        raise AssertionError(f"{st.decode_graph_captures - before} "
                             "recordings after one rebind")
    k1_eager = streamed_matmul.launches
    eager = _ms_per_step(lambda: ex._run_decode(*args))
    k1_eager = streamed_matmul.launches - k1_eager
    if k1 != k1_eager or k1 == 0:
        raise AssertionError(f"K1 launched {k1} times in 20 graphed passes, "
                             f"{k1_eager} in 20 eager ones")
    out = {"model": model, "steps": 16 + steps,
           "own_tiers": sorted(set(own)), "tiers": sorted(set(tiers)),
           "captures": before, "replays": 16 + steps - before,
           "k1_per_pass": k1 / 20, "graphed_ms": graphed, "eager_ms": eager}
    sess.close()
    return out


def concurrent_cublas_check(device, recordings=4):
    """A thread's cuBLAS matmuls on a stream of its own while this thread
    records decode passes (``_graph_session``, qwen3-14b), each recording
    clearing cuBLAS's workspaces: every result of the thread is
    ``torch.equal`` to its first. Returns the thread's matmul count."""
    import torch
    from repro_torch.models.common import greedy_token
    sess, _ = _graph_session("qwen3-14b", device)
    ex = sess.executor
    g = torch.Generator(device=device).manual_seed(7)
    a, b = (torch.randn((256, 4096), generator=g, device=device,
                        dtype=torch.bfloat16),
            torch.randn((4096, 4096), generator=g, device=device,
                        dtype=torch.bfloat16))
    ready, stop = threading.Event(), threading.Event()
    seen = {"n": 0, "bad": 0, "error": None}

    def other():
        try:
            with torch.cuda.stream(torch.cuda.Stream(device)):
                want = a @ b
                ready.set()
                while not stop.is_set():
                    if not torch.equal(a @ b, want):
                        seen["bad"] += 1
                    seen["n"] += 1
        except Exception as e:  # noqa: BLE001 (reported below)
            seen["error"] = repr(e)
        finally:
            ready.set()

    t = threading.Thread(target=other, daemon=True)
    t.start()
    ready.wait(60)
    kv = ex.init_kv(MAX_BATCH)
    args = (torch.zeros((MAX_BATCH, 1), dtype=torch.int32, device=device),
            kv, torch.full((MAX_BATCH,), 8, dtype=torch.int32,
                           device=device),
            torch.ones(MAX_BATCH, dtype=torch.bool, device=device),
            MAX_BATCH)
    try:
        for _ in range(recordings):
            ex.rebind(ex.schedule)
            for _ in range(3):
                ex.decode_fused(*args, pick=greedy_token)
            time.sleep(0.05)
    finally:
        stop.set()
        t.join(120)
    if t.is_alive() or seen["error"] or seen["bad"] or seen["n"] == 0:
        raise AssertionError(f"the other thread's matmuls: {seen}, alive "
                             f"{t.is_alive()}")
    if ex.stats.decode_graph_captures != recordings:
        raise AssertionError(f"{ex.stats.decode_graph_captures} recordings")
    sess.close()
    return seen["n"]


def decode_graph_path():
    """Phase 20: ``decode_graph_check`` for a dense and a hybrid resident
    plan, and ``concurrent_cublas_check``."""
    import torch
    dev = torch.device("cuda")
    out = {}
    for model in ("qwen3-14b", "nemotron-h"):
        row = decode_graph_check(model, dev)
        free_cuda()
        log(f"decode graphs {model}: {row['steps']} graphed fused passes "
            f"torch.equal to eager (logits, tokens, caches), the card's own "
            f"tiers {row['own_tiers']} then {row['tiers']}; "
            f"{row['captures']} recordings, {row['replays']} replays, 1 "
            f"recording after a rebind; K1 {row['k1_per_pass']:g} launches "
            f"a pass, graphed and eager alike; a step at {MAX_BATCH} "
            f"active: graphed {row['graphed_ms']:.3f} ms, eager "
            f"{row['eager_ms']:.3f} ms")
        out[model] = row
    n = concurrent_cublas_check(dev)
    free_cuda()
    log(f"decode graphs: {n} matmuls of another thread across 4 "
        "recordings, each torch.equal to its first")
    out["concurrent_matmuls"] = n
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
        "flash_attention.cu",
        "flash_attention_backward": "bf16 (training at T > 2048): "
        + source_design("flash_attention_bwd_mma") + " f32 (and bf16 at "
        "unaligned shapes): " + source_design("flash_attention_bwd")}


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
    laps = {"_last": t_start}

    def lap(name):
        """Seconds since the previous lap, logged and kept by phase."""
        now = time.perf_counter()
        laps[name] = now - laps["_last"]
        laps["_last"] = now
        log(f"[{now - t_start:.1f} s] {name}: {laps[name]:.1f} s")
    card = card_line()
    log(card)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}")
    build_kernels()
    lap("build")
    kern = kernel_phase()
    free_cuda()
    qkern = quant_kernel_phase()
    free_cuda()
    lap("K1-K3 checks")
    fkern = flash_kernel_phase()
    lap("K4 checks")
    bkern = flash_bwd_phase()
    lap("K4 backward checks")

    def headline(shapes):
        return next(s for s in shapes if s["M"] == 4 and s["K"] == 896)

    main = main_path()
    free_cuda()
    lap("phases 3-7, 12")
    vision = vision_path()
    language = language_path()
    planning = vlm_planning(main["link_gbps"])
    free_cuda()
    lap("phases 8-10")
    moe = moe_path(main["link_gbps"])
    free_cuda()
    lap("phase 11")
    draft_cfg, draft_params = main.pop("model")
    spec = spec_path(main["link_gbps"], draft_cfg, draft_params)
    free_cuda()
    lap("phase 13")
    db, system, total = main.pop("setup")
    faults = fault_path(draft_cfg, draft_params, db, system, total,
                        main.pop("base_01"))
    gateway = gateway_path(draft_cfg, draft_params, db, system, total)
    del draft_params, db
    free_cuda()
    lap("phases 14-15")
    families = families_path(main["link_gbps"])
    lap("phase 16")
    training = training_path()
    lap("phase 17")
    counts = counting_path()
    lap("phase 18")
    examples = examples_path()
    lap("phase 19")
    decode_graphs = decode_graph_path()
    lap("phase 20")
    faults.update({"moe": moe.pop("faults"), "spec": spec.pop("faults")})
    log(json.dumps({"main_path": main["rows"],
                    "quant_paths": main["quant"],
                    "link_gbps": main["link_gbps"],
                    "profile": main["profile"],
                    "vlm": {"vision": vision, "language": language,
                            "planning": planning,
                            "k4_block_q_bit_equal":
                                fkern["block_q_bit_equal"]},
                    "moe": moe, "paged": main["paged"], "spec": spec,
                    "faults": faults, "gateway": gateway,
                    "families": families, "training": training,
                    "counts": counts, "examples": examples["twins"],
                    "decode_graphs": decode_graphs,
                    "k4_backward": bkern,
                    "phase_seconds": {k: v for k, v in laps.items()
                                      if k != "_last"},
                    "seconds": time.perf_counter() - t_start}))
    # kernel -> (the MoE run's tag, its results)
    moe_q = {kname: (qtag, moe["quant"][qtag])
             for qtag, _, kname in MOE_QUANT}
    # phase 18's counted runs on the card, K4 forward and backward
    counted = {unit: {f"counted {kind} (phase 18)":
                      counts[kind]["launches"][unit]
                      for kind in ("train", "prefill", "decode")
                      if counts[kind]["launches"][unit]}
               for unit in ("K4", "K4bwd")}
    kernels = [
        kernel_entry("streamed_matmul", "streamed_matmul.py:95",
                     main["launches"] + moe["launches"]
                     + main["paged"]["launches"] + spec["launches"]
                     + spec["draft_launches"] + faults["launches"]
                     + faults["moe"]["launches"] + faults["spec"]["k1"]
                     + gateway["launches"] + training["k1_launches"]
                     + sum(examples["k1_by_path"].values()),
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
                     vision["launches"] + language["launches"]
                     + sum(families["launches"].values())
                     + sum(training["k4_by_path"].values())
                     + sum(counted["K4"].values())
                     + sum(examples["k4_by_path"].values()),
                     fkern["max_abs_err"], fkern["shapes"],
                     next(s for s in fkern["shapes"] if s["tag"] == "vision"),
                     source="flash_attention_mma"),
        kernel_entry("flash_attention_backward", "flash_attention.py:104",
                     sum(training["k4_bwd_by_path"].values())
                     + sum(counted["K4bwd"].values())
                     + sum(examples["k4_bwd_by_path"].values()),
                     bkern["max_abs_err"], bkern["shapes"],
                     bkern["shapes"][0], source="flash_attention_bwd_mma")]
    kernels[0].update({"launches_by_path": {
                           "qwen2-0.5b": main["launches"],
                           MOE_ARCH: moe["launches"],
                           "qwen2-0.5b paged": main["paged"]["launches"],
                           f"{SPEC_ARCH} spec": spec["launches"],
                           f"{SPEC_ARCH} spec, its draft":
                               spec["draft_launches"],
                           "qwen2-0.5b faults (and paged)":
                               faults["launches"],
                           f"{MOE_ARCH} faults": faults["moe"]["launches"],
                           f"{SPEC_ARCH} spec faults, with its draft":
                               faults["spec"]["k1"],
                           "qwen2-0.5b gateway": gateway["launches"],
                           "training (phase 17)": training["k1_launches"],
                           **examples["k1_by_path"]},
                       "launches_by_variant": {
                           "qwen2-0.5b": main["variants"]["K1"],
                           MOE_ARCH: moe["variants"],
                           "qwen2-0.5b paged": main["paged"]["variants"],
                           f"{SPEC_ARCH} spec and its draft":
                               spec["variants"]},
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
            "planted_faults": qkern[mode]["faults"],
            "library": qkern[mode]["library"]})
    kernels[-1].update({
        "completes": "the forward K4 (flash_attention.py:104), whose "
                     "Pallas kernel has no backward: the reference "
                     "differentiates its jnp attend_flash by autodiff",
        "launches_by_path": {**training["k4_bwd_by_path"],
                             **counted["K4bwd"],
                             **examples["k4_bwd_by_path"]},
        "checked_shapes": bkern["checked"],
        "check_launches_by_variant": bkern["variant_launches"],
        "planted_faults": bkern["planted_faults"]})
    kernels[-2].update({
        "launches_by_path": {
            "vision_720p_encode": vision["launches"],
            f"language_forward_T{language['T']}": language["launches"],
            **families["launches"], **training["k4_by_path"],
            **counted["K4"], **examples["k4_by_path"]},
        "launches_by_variant": {
            "vision_720p_encode": vision["variant_launches"],
            f"language_forward_T{language['T']}":
                language["variant_launches"],
            **families["variants"]},
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
