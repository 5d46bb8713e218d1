#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases (each raises on failure; the last line is printed only if all pass):

1. environment: the card's name and power limit, torch and CUDA versions;
   builds the port's CUDA kernels (K1, K2, K3: one source) from
   ``src/repro_torch/kernels/csrc``;
2. kernels: K1 (streamed_matmul) against its plain PyTorch version at the
   main path's shapes and at ragged shapes, bf16 and f32; row independence
   bit for bit; times of the kernel, the plain version and ``torch.matmul``
   (the yardstick only — the port never calls it) with CUDA events. Then
   K2 (streamed_matmul_int8) and K3 (streamed_matmul_int4) on weights
   quantised on the card by the port's quantisers, at the main path's
   shapes, at qwen3-14b's FFN widths, and at ragged and odd quantisation
   groups, bf16 and f32; row independence; their times, their plain
   versions' times and, as context only, ``torch.matmul`` on the
   dequantised bf16 weight (not the same function: no single PyTorch call
   computes these, so their ``library_ms`` is null);
3. main path: full-width, full-depth qwen2-0.5b with seeded random bf16
   weights, served through ``Session.open`` -> ``serve`` at VRAM budgets of
   2.0x, 0.5x and 0.1x of the model's weight bytes on the measured link:
   identical tokens across budgets, the streamed-bytes ledger, K1's launch
   count, peak device memory within a computed bound, and the served
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
   three per FFN call and no K1 launch, no ``_dequant`` call, peak memory
   within the bound, the teacher-forced check; at 0.1x in int4 also
   overlap == sync and per-slot == fused; a profile of int4 decode.

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
    from repro_torch.kernels import streamed_matmul as sm
    lib = sm.LIBRARY
    t0 = time.perf_counter()
    lib.lib()
    log(f"built K1, K2, K3 ({', '.join(lib.symbols)}): "
        f"{lib.library_path().name} "
        f"(nvcc {lib.build_s if lib.build_s is not None else 0.0:.2f} s)")
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
    from repro_torch.kernels.streamed_matmul import streamed_matmul
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1234)
    before = streamed_matmul.launches
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
    # the main path's shapes, bf16, timed
    for (K, N) in ((896, 4864), (4864, 896)):
        n_copies = max(2, -(-2 * L2_BYTES // (K * N * 2)))
        ws = [(torch.randn((K, N), generator=gen, device=dev) / K ** 0.5)
              .to(torch.bfloat16) for _ in range(n_copies)]
        for M in (1, 4, 64, 256):
            x = torch.randn((M, K), generator=gen, device=dev) \
                .to(torch.bfloat16)
            out = streamed_matmul(x, ws[0])
            e = check_close(f"K1 bf16 ({M},{K})@({K},{N})", out,
                            kref.streamed_matmul_ref(x, ws[0]), "bfloat16")
            max_err = max(max_err, e)
            args = [(x, w) for w in ws]
            ms = time_ms(streamed_matmul, args)
            plain_ms = time_ms(kref.streamed_matmul_ref, args)
            lib_ms = time_ms(torch.matmul, args)
            b_ms, b_by = bound(M, K, N, 2, PEAK_BF16_FLOPS)
            shapes.append({"M": M, "K": K, "N": N, "dtype": "bfloat16",
                           "max_abs_err": e, "ms": ms, "plain_ms": plain_ms,
                           "library_ms": lib_ms, "bound_ms": b_ms,
                           "bound_by": b_by})
            log(f"K1 ({M},{K})@({K},{N}) bf16: kernel {ms:.4f} ms, plain "
                f"{plain_ms:.4f} ms, torch.matmul {lib_ms:.4f} ms, bound "
                f"{b_ms:.4f} ms ({b_by}), max |err| {e:.3e}")
        del ws
    # row independence: kernel(x)[rows] == kernel(x[rows]) bit for bit,
    # across both tile configurations (M <= 16 and M > 16)
    for (K, N) in ((896, 4864), (4864, 896), (112, 56)):
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
    torch.cuda.synchronize()
    log("K1 row results independent of M: bit for bit")
    return {"max_abs_err": max_err, "shapes": shapes,
            "check_launches": streamed_matmul.launches - before}


def _quantise(mode, w, group=None):
    """The port's quantiser of ``mode`` on ``w``; returns the kernel's
    weight operands (codes, scales[, zeros])."""
    from repro_torch.kernels import streamed_matmul as sm
    if mode == "int8":
        return sm.quantize_int8(w, block_k=group or sm.GROUP_SIZE)
    return sm.quantize_int4(w, group_size=group or sm.GROUP_SIZE)


def quant_kernel_phase():
    """K2 and K3 against their plain versions on the card, timed at the
    main path's and qwen3-14b's FFN shapes; ragged and odd groups; row
    independence."""
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
    out = {m: {"max_abs_err": 0.0, "shapes": []} for m in QUANT_MODES}

    def check(mode, tag, x, q):
        e = check_close(f"{mode} {tag}", kern[mode](x, *q),
                        plain[mode](x, *q), str(x.dtype).split(".")[-1])
        out[mode]["max_abs_err"] = max(out[mode]["max_abs_err"], e)
        return e

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
    # K=250: 2 groups of 125, the nibbles of one byte in two groups)
    for mode in QUANT_MODES:
        for dtype in (torch.bfloat16, torch.float32):
            for (M, K, N, group) in ((3, 700, 129, 128), (17, 700, 96, 128),
                                     (1, 250, 70, 128), (65, 250, 64, 128),
                                     (4, 250, 33, 64), (20, 56, 112, 128),
                                     (5, 4864, 896, 64)):
                w = torch.randn((K, N), generator=gen, device=dev)
                x = torch.randn((M, K), generator=gen, device=dev).to(dtype)
                check(mode, f"{dtype} ({M},{K})@({K},{N}) g{group}", x,
                      _quantise(mode, w, group))
        log(f"{mode} ragged/odd groups within tolerance (max |err| "
            f"{out[mode]['max_abs_err']:.3e})")
    # the main path's and qwen3-14b's FFN shapes, bf16, timed
    for (K, N, Ms) in ((896, 4864, (1, 4, 64, 256)),
                       (4864, 896, (1, 4, 64, 256)),
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
                e = check(mode, f"bf16 ({M},{K})@({K},{N})", x, q)
                args = [(x,) + qq for qq in qs]
                ms = time_ms(kern[mode], args)
                plain_ms = time_ms(plain[mode], args)
                ctx_ms = time_ms(torch.matmul, [(x, d) for d in wds])
                b_ms, b_by = bound(M, K, N, 2, PEAK_BF16_FLOPS,
                                   w_bytes=w_bytes)
                out[mode]["shapes"].append(
                    {"M": M, "K": K, "N": N, "dtype": "bfloat16",
                     "w_bytes": w_bytes, "max_abs_err": e, "ms": ms,
                     "plain_ms": plain_ms, "library_ms": None,
                     "bf16_matmul_context_ms": ctx_ms, "bound_ms": b_ms,
                     "bound_by": b_by})
                log(f"{mode} ({M},{K})@({K},{N}) bf16 x: kernel {ms:.4f} "
                    f"ms, plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms "
                    f"({b_by}, {w_bytes} weight bytes), max |err| {e:.3e}; "
                    f"context, not the same function: torch.matmul on the "
                    f"dequantised bf16 weight {ctx_ms:.4f} ms")
            del qs, wds, wd
        del w
        free_cuda()
    # row independence, both tile configurations, ragged groups too
    for mode in QUANT_MODES:
        for (K, N) in ((896, 4864), (4864, 896), (250, 70)):
            w = torch.randn((K, N), generator=gen, device=dev)
            q = _quantise(mode, w)
            for dtype in (torch.bfloat16, torch.float32):
                x = torch.randn((256, K), generator=gen, device=dev).to(dtype)
                full = kern[mode](x, *q)
                for rows in ((0, 1), (3, 4), (0, 4), (5, 21), (100, 164),
                             (0, 256)):
                    part = kern[mode](x[rows[0]:rows[1]].contiguous(), *q)
                    if not torch.equal(part, full[rows[0]:rows[1]]):
                        raise AssertionError(
                            f"{mode} rows {rows} of ({K},{N}) {dtype} "
                            "depend on M")
    torch.cuda.synchronize()
    log("K2, K3 row results independent of M: bit for bit")
    for m in QUANT_MODES:
        out[m]["check_launches"] = kern[m].launches - before[m]
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
    keeps outside the planned budget counted in."""
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
    at_use = max(tree_nbytes(ex._subtree(s)) for s in sess.subs
                 if s.kind in ("attn", "ffn"))
    kv = 2 * cfg.n_layers * MAX_BATCH * cfg.n_kv_heads * MAX_SEQ \
        * cfg.resolved_head_dim * 2
    resident = tree_nbytes({k: ex.host[k] for k in ex.host})
    parts = {"pinned": pinned, "scratch": scratch, "at_use_one_sublayer":
             at_use, "kv": kv, "embed_norm_head": resident,
             "activations": ACT_ALLOWANCE}
    return sum(parts.values()), parts


def serve_once(cfg, params, db, system, budget, *, overlap=True,
               fused=True, prefill_mode=None, rebudget_to=None,
               rebudget_after=2, n_req=N_REQ, new_tokens=NEW_TOKENS):
    import torch
    from repro_torch import Session
    from repro_torch.core import InferenceSetting, random_requests
    free_cuda()
    torch.cuda.reset_peak_memory_stats()
    sess = Session.open(cfg, system=system, budget_bytes=budget,
                        setting=InferenceSetting(batch=MAX_BATCH,
                                                 context=MAX_SEQ),
                        db=db, params=params, max_seq=MAX_SEQ,
                        overlap=overlap, prefill_mode=prefill_mode)
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
    return row


def teacher_forced_check(cfg, params, tokens, prompts):
    """The served tokens against the port's monolithic forward on the card:
    every served token must be the argmax of the monolithic logits at its
    position, up to the near-tie margin ``TF_GAP`` (the monolithic FFN runs
    through torch.matmul on bf16 weights, dequantised to bf16 where they
    are quantised; the served one through K1, K2 or K3 in f32)."""
    import torch
    from repro_torch.models import build_model
    from repro_torch.models.common import tree_map
    dev_params = tree_map(lambda t: t.to("cuda"), params)
    model = build_model(cfg).module(dev_params)
    worst = 0.0
    for prompt, gen in zip(prompts, tokens):
        seq = torch.as_tensor(list(prompt) + gen[:-1], dtype=torch.int32,
                              device="cuda")[None]
        logits, _ = model(seq)
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
    main_launches = counts["K1"]
    if counts["K2"] or counts["K3"]:
        raise AssertionError(f"quantised kernels ran on the bf16 path: "
                             f"{counts}")
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
    log(f"K1 launches on the main path: {main_launches}")
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
    return {"rows": rows, "launches": main_launches, "link_gbps": link,
            "profile": prof, "quant": quant}


KERNEL_OF = {"int8": "K2", "int4": "K3"}


def _counters():
    from repro_torch.kernels import streamed_matmul as sm
    return {"K1": sm.streamed_matmul, "K2": sm.streamed_matmul_int8,
            "K3": sm.streamed_matmul_int4}


def reset_launches():
    for fn in _counters().values():
        fn.launches = 0


def read_launches():
    return {name: fn.launches for name, fn in _counters().items()}


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
    dequant_calls = [0]
    real_dequant = mlp._dequant

    def counting_dequant(*a, **kw):
        dequant_calls[0] += 1
        return real_dequant(*a, **kw)

    # launches counted over exactly this mode's main-path run
    reset_launches()
    mlp._dequant = counting_dequant
    try:
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
    finally:
        mlp._dequant = real_dequant
    counts = read_launches()
    want_counts = {k: 0 for k in counts}
    want_counts[kname] = 3 * ffn_calls      # gate, up, down per FFN call
    if counts != want_counts:
        raise AssertionError(f"{mode}: launches {counts} != {want_counts} "
                             f"(three {kname} per FFN call, nothing else)")
    if dequant_calls[0]:
        raise AssertionError(f"{mode}: the served path called _dequant "
                             f"{dequant_calls[0]} times")
    log(f"{kname} launches on the {mode} main path: {counts[kname]} == 3 x "
        f"{ffn_calls} FFN calls; K1 and the other kernel 0; _dequant 0")
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
    return {"rows": rows, "launches": counts[kname], "total_bytes": total,
            "teacher_forced_gap": gap, "agreement": agree,
            "profile": prof}


def profile_phase(cfg, params, db, system, budget, steps=4, tag="0.1x"):
    """Device time by kernel over ``steps`` fused decode iterations of a
    full batch, and the share of the window's wall time in which the card
    ran a kernel (copies run on their own stream and are listed apart)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
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
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            b.step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    b.serve([])
    sess.close()
    kernels, copies, host_ops = {}, {}, {}
    launches = 0
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            host_ops[e.key] = e.self_cpu_time_total
            continue
        if e.key.lower().startswith("memcpy"):
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
    mm_us = sum(us for k, us in kernels.items()
                if "(anonymous namespace)::mm_kernel<" in k)
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


def kernel_entry(name, source_line, launches, max_err, shapes, headline):
    """One kernel's entry of the ``{"kernels": [...]}`` line: the numbers
    at the ``headline`` shape (the up/gate projection at decode, M=4)."""
    return {"name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/streamed_matmul.cu",
            "replaces": f"src/repro/kernels/streamed_matmul.py:{source_line}",
            "launches": launches, "max_abs_err": max_err,
            "ms": headline["ms"], "plain_ms": headline["plain_ms"],
            "bound_ms": headline["bound_ms"],
            "bound_by": headline["bound_by"],
            "library_ms": headline["library_ms"],
            "shape": [headline["M"], headline["K"], headline["N"]],
            "shapes": shapes}


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

    def headline(shapes):
        return next(s for s in shapes if s["M"] == 4 and s["K"] == 896)

    main = main_path()
    log(json.dumps({"main_path": main["rows"],
                    "quant_paths": main["quant"],
                    "link_gbps": main["link_gbps"],
                    "profile": main["profile"],
                    "seconds": time.perf_counter() - t_start}))
    kernels = [
        kernel_entry("streamed_matmul", 95, main["launches"],
                     kern["max_abs_err"], kern["shapes"],
                     headline(kern["shapes"])),
        kernel_entry("streamed_matmul_int8", 212,
                     main["quant"]["int8"]["launches"],
                     qkern["int8"]["max_abs_err"], qkern["int8"]["shapes"],
                     headline(qkern["int8"]["shapes"])),
        kernel_entry("streamed_matmul_int4", 289,
                     main["quant"]["int4"]["launches"],
                     qkern["int4"]["max_abs_err"], qkern["int4"]["shapes"],
                     headline(qkern["int4"]["shapes"]))]
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
