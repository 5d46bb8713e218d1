#!/usr/bin/env python3
"""Time K1, K2, K3 and K4 in bf16 at the main paths' shapes on one card.

    python3 kernel_times.py [--src DIR] [--encode]

Imports ``repro_torch`` from ``DIR`` (this checkout's ``src`` by default),
so that two trees can be timed in one call on one card: unpack the other
tree's ``git archive`` under ``build/`` and pass its ``src``. For each
shape it prints two times per call, both over weight (or q, k, v) copies
larger than the L2 cache: ``ms``, CUDA events around back-to-back wrapper
calls (host work included), and ``device_ms``, the kernels' own device
time from ``torch.profiler`` (any streamed-matmul or K4 kernel,
whichever the tree runs). The shapes are ``chip_smoke.py``'s: K1, K2
(int8) and K3 (int4) at qwen2-0.5b's FFN projections for M = 1, 4, 64,
256 and at qwen3-14b's for M = 1, 4, K2 and K3 on weights quantised on
the card by the tree's own quantisers; K4 at the 720p vision encoder's
and qwen2-vl-7b's T=4096 attention. With ``--encode`` it times the
tree's whole VLM vision encoder instead (``encode_times``). The last
line is one JSON object.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import chip_smoke as cs


def encode_times(vlmopt, reps=3):
    """The tree's vision encoder (``VisionConfig()``, seeded bf16 weights,
    B=1): ``reps`` encodes each at 720p flash, 720p plain and 1440p flash,
    every one on fresh seeded patches, with its wall seconds (host clock,
    synchronised) and peak device bytes (weights included) beside
    ``vision_vram_demand``."""
    import torch
    vc = vlmopt.VisionConfig()
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = vlmopt.init_vision_params(gen, vc, torch.bfloat16)
    for flash in (True, False):     # warm-up: library loading, builds
        vlmopt.vision_encode(params, vc, torch.zeros(
            (1, 64, vc.d), dtype=torch.bfloat16, device="cuda"), flash=flash)
    pg = torch.Generator(device="cuda").manual_seed(1)
    out = []
    for res, flash in (("720p", True), ("720p", False), ("1440p", True)):
        n = vlmopt.n_vision_tokens(vc, res)
        walls, peaks = [], []
        for _ in range(reps):
            patches = torch.randn((1, n, vc.d), generator=pg,
                                  device="cuda").to(torch.bfloat16)
            cs.free_cuda()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            y = vlmopt.vision_encode(params, vc, patches, flash=flash)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            peaks.append(torch.cuda.max_memory_allocated())
            del y, patches
        demand = vlmopt.vision_vram_demand(vc, res, offload=False,
                                           flash=flash)
        out.append({"res": res, "flash": flash, "n": n, "wall_s": walls,
                    "peak_bytes": peaks, "demand_bytes": demand})
        cs.log(f"encode {res} {'flash' if flash else 'plain'}: wall "
               f"{', '.join(f'{w:.4f}' for w in walls)} s, peak "
               f"{max(peaks) / 1e6:.1f} MB (demand {demand / 1e6:.1f} MB)")
    del params
    cs.free_cuda()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(cs.SRC),
                    help="directory holding the repro_torch package")
    ap.add_argument("--encode", action="store_true",
                    help="time the vision encoder, not the kernels")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("kernel_times: no CUDA device", file=sys.stderr)
        return 2
    src = Path(args.src).resolve()
    if not (src / "repro_torch").is_dir():
        print(f"kernel_times: no repro_torch under {src}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    if args.encode:
        from repro_torch.core import vlmopt
        card = cs.card_line()
        cs.log(card)
        print(json.dumps({"card": card, "src": str(src),
                          "encode": encode_times(vlmopt)}))
        return 0
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import streamed_matmul as sm
    from repro_torch.kernels.streamed_matmul import streamed_matmul
    card = cs.card_line()
    cs.log(card)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1234)
    k1 = []
    for (K, N, Ms) in ((896, 4864, (1, 4, 64, 256)),
                       (4864, 896, (1, 4, 64, 256)),
                       (5120, 17408, (1, 4)), (17408, 5120, (1, 4))):
        n_copies = max(2, -(-2 * cs.L2_BYTES // (K * N * 2)))
        ws = [(torch.randn((K, N), generator=gen, device=dev) / K ** 0.5)
              .to(torch.bfloat16) for _ in range(n_copies)]
        for M in Ms:
            x = torch.randn((M, K), generator=gen, device=dev) \
                .to(torch.bfloat16)
            a = [(x, w) for w in ws]
            ms = cs.time_ms(streamed_matmul, a)
            dev_ms = cs.device_ms(streamed_matmul, a,
                                  (cs.MM_MMA, cs.MM_FMA))
            k1.append({"M": M, "K": K, "N": N, "ms": ms,
                       "device_ms": dev_ms})
            cs.log(f"K1 ({M},{K})@({K},{N}) bf16: {ms:.4f} ms, device "
                   f"{cs.fmt_ms(dev_ms)}")
        del ws
        cs.free_cuda()
    quant = {"int8": [], "int4": []}
    kern = {"int8": sm.streamed_matmul_int8, "int4": sm.streamed_matmul_int4}
    for (K, N, Ms) in ((896, 4864, (1, 4, 64, 256)),
                       (4864, 896, (1, 4, 64, 256)),
                       (5120, 17408, (1, 4)), (17408, 5120, (1, 4))):
        w = (torch.randn((K, N), generator=gen, device=dev) / K ** 0.5) \
            .to(torch.bfloat16)
        for mode in quant:
            q = cs._quantise(mode, w)
            w_bytes = sum(t.numel() * t.element_size() for t in q)
            qs = [q] + [tuple(t.clone() for t in q) for _ in
                        range(max(2, -(-2 * cs.L2_BYTES // w_bytes)) - 1)]
            for M in Ms:
                x = torch.randn((M, K), generator=gen, device=dev) \
                    .to(torch.bfloat16)
                a = [(x,) + qq for qq in qs]
                ms = cs.time_ms(kern[mode], a)
                dev_ms = cs.device_ms(kern[mode], a, (cs.MM_MMA, cs.MM_FMA))
                quant[mode].append({"M": M, "K": K, "N": N, "ms": ms,
                                    "device_ms": dev_ms})
                cs.log(f"{cs.KERNEL_OF[mode]} {mode} ({M},{K})@({K},{N}) "
                       f"bf16: {ms:.4f} ms, device {cs.fmt_ms(dev_ms)}")
            del qs, q
        del w
        cs.free_cuda()
    k4 = []
    for tag, shape, causal in (("vision", cs.VISION_SHAPE, False),
                               ("language", cs.LANGUAGE_SHAPE, True)):
        B, H, KV, Tq, Tk, hd = shape
        set_bytes = (2 * B * H * Tq + 2 * B * KV * Tk) * hd * 2
        sets = cs._qkv(gen, shape, torch.bfloat16,
                       max(2, -(-2 * cs.L2_BYTES // set_bytes)))

        def call(q, k, v):
            return fa.flash_attention(q, k, v, causal=causal,
                                      block_q=1024, block_k=1024)
        ms = cs.time_ms(call, sets, iters=10)
        dev_ms = cs.device_ms(call, sets, (cs.FLASH_MMA, cs.FLASH_FMA),
                              iters=10)
        k4.append({"tag": tag, "shape": list(shape), "ms": ms,
                   "device_ms": dev_ms})
        cs.log(f"K4 {tag} {shape} bf16: {ms:.4f} ms, device "
               f"{cs.fmt_ms(dev_ms)}")
        del sets
        cs.free_cuda()
    print(json.dumps({"card": card, "src": str(src), "k1": k1,
                      "k2": quant["int8"], "k3": quant["int4"], "k4": k4}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
