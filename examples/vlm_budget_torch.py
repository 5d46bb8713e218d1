"""PyTorch twin of ``vlm_budget.py``: high-resolution vision encoding under
a VRAM budget, on the CUDA card unless ``--device cpu``.

Shows (a) the runnable flash/Q-chunked vision encoder matching the
full-attention one (on the card its attention runs through the
hand-written flash attention kernel, one launch per layer and Q-chunk),
(b) the analytic VRAM-demand grid reproducing the paper's OOM pattern and
~10x reduction for CR1-class models, and (c) the language-side tier plan
for the paper's VLM arch under client budgets via a planning-only
``repro_torch.Session``.

    PYTHONPATH=src python examples/vlm_budget_torch.py
    PYTHONPATH=src python examples/vlm_budget_torch.py --device cpu
"""
import argparse

import torch

from repro_torch import Session
from repro_torch.configs import get_config
from repro_torch.core import CLI1, InferenceSetting, run_install
from repro_torch.core.vlmopt import (RESOLUTIONS, VisionConfig,
                                     init_vision_params, n_vision_tokens,
                                     vision_encode, vlm_peak_vram)
from repro_torch.device import resolve_device

Q_CHUNKS = (32, 64, 128)


def main(argv=None):
    """Parse ``argv`` (``sys.argv[1:]`` when None), print the reference's
    lines and return what they show: each Q-chunk's error, the grid, the
    reduction and the language-side plans."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="'cpu' to run on the host (default: the card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    # runnable: small encoder, flash vs reference numerics. The encoder
    # writes its result into the patches it is given, so each encode takes
    # a copy.
    vc_small = VisionConfig(d=64, layers=2, heads=4)
    params = init_vision_params(
        torch.Generator(device=device).manual_seed(0), vc_small,
        torch.float32)
    patches = torch.randn((1, 256, 64), device=device,
                          generator=torch.Generator(device=device)
                          .manual_seed(1))
    ref = vision_encode(params, vc_small, patches.clone(), flash=False,
                        device=device)
    flash = []
    for qc in Q_CHUNKS:
        out = vision_encode(params, vc_small, patches.clone(), flash=True,
                            q_chunk=qc, device=device)
        err = float((out - ref).abs().max())
        flash.append({"q_chunk": qc, "max_err": err})
        print(f"flash q_chunk={qc:4d}: max err vs full attention {err:.2e}")

    # analytic: CR1-class demand grid (paper Tables 7-8 shape)
    vc = VisionConfig()
    print("\nVRAM feasibility (baseline -> VLMOpt), CR1-class encoder:")
    print(f"{'res':>7s} {'tokens':>7s} " + " ".join(f"{b:>7}" for b in
          ("2G", "8G", "14.5G", "20G")))
    grid = []
    for res in RESOLUTIONS:
        row = []
        for bg in (2e9, 8e9, 14.5e9, 20e9):
            base = vlm_peak_vram(vc, res, int(6e9), vlmopt=False) <= bg
            opt = vlm_peak_vram(vc, res, int(1.2e9), vlmopt=True) <= bg
            row.append(f"{'ok' if base else 'OOM'}->{'ok' if opt else 'OOM'}")
        grid.append({"res": res, "tokens": n_vision_tokens(vc, res),
                     "cells": row})
        print(f"{res:>7s} {n_vision_tokens(vc, res):7d} "
              + " ".join(f"{r:>7s}" for r in row))
    red = 20e9 / vlm_peak_vram(vc, "1440p", int(1.2e9), vlmopt=True)
    print(f"\n1440p peak-VRAM reduction vs the paper's 20G vLLM baseline: "
          f"{red:.1f}x")

    # language side: plan the paper's VLM arch under laptop-class budgets
    # (planning-only Session — vlm executes through the encoder above;
    # the tier table covers the decode-phase language stack)
    full = get_config("qwen2-vl-7b")
    db = run_install(CLI1, quick=True)  # one install profile for both plans
    print(f"\n{full.name} language-stack tier plan on {CLI1.name}:")
    plans = []
    for gb in (4.0, 8.0):
        sess = Session.open(full, CLI1, int(gb * 1e9),
                            InferenceSetting(batch=1, context=4096), db=db,
                            device=device)
        est = sess.estimates(4096)
        plans.append({"budget_gb": gb, "pinned_bytes": est["pinned_bytes"],
                      "ttft_s": est["ttft_s"], "tps": est["tps"]})
        print(f"  {gb:4.1f}G: pinned {est['pinned_bytes']/1e9:5.2f}G "
              f"est TTFT(4k) {est['ttft_s']:6.2f}s "
              f"est TPS {est['tps']:6.1f}")
    return {"flash": flash, "grid": grid, "reduction": red, "plans": plans}


if __name__ == "__main__":
    main()
