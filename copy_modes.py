#!/usr/bin/env python3
"""Decode speed of the streamed path under each way the host waits for
its copies, on one card.

    python3 copy_modes.py [--rounds N] [--after-profiler] [--moe]
                          [--moe-modes MODE,MODE,...]

Serves qwen2-0.5b (full width and depth, seeded weights, pinned) with
``chip_smoke.py``'s traffic (4 requests of 64 prompt and 16 new tokens,
``max_batch=4``) at 0.1x of its weight bytes, where most sub-layers
stream; with ``--moe`` also qwen30b-a3b as ``chip_smoke.py``'s phase 11
serves it (12 of 48 layers), expert-granular at 0.1x, in the modes
``--moe-modes`` names (default: the first two). ``--after-profiler``
first runs one ``torch.profiler`` window
over a few matmuls, as ``chip_smoke.py``'s kernel phase does before it
serves. Each round runs every mode once, in turn:

- ``sync``: overlap off; the serving thread copies each streamed
  sub-layer itself, at use;
- ``pipelined``: the prefetch worker copies one sub-layer ahead;
- ``pipelined-yield``: pipelined, with every CUDA event the host waits on
  made blocking (``torch.cuda.Event(blocking=True)``), so a waiting thread
  sleeps in the driver instead of spinning;
- ``pipelined-switch``: pipelined, with the interpreter's switch interval
  at 0.5 ms instead of 5 ms, so a thread waiting for the interpreter lock
  gets it sooner;
- ``pipelined-no-demand`` (MoE): pipelined static sub-layers, but every
  cold expert fetched at use by the serving thread (the demand pool
  unused);
- ``pipelined-issue``: pipelined, but a worker does not wait on the host
  for the copies it issued: the compute stream alone waits for them.

Per run it prints decode tok/s (decode-only steps) and TTFT; the tokens
of every run must be identical. Where the host waits in each mode is what
``torch.profiler`` and the port's spans show (``core/trace.py``).
The last line is one JSON object.
"""
from __future__ import annotations

import argparse
import json
import sys

import chip_smoke as cs

MODES = ("sync", "pipelined", "pipelined-yield", "pipelined-switch")
MOE_MODES = MODES + ("pipelined-no-demand", "pipelined-issue")


def _stage_no_wait(groups, device, stream, span=None):
    """``prefetch.stage_groups`` without the host's wait for the copy (and
    untimed)."""
    import torch
    from repro_torch.core.prefetch import groups_to_device
    with torch.cuda.device(device), torch.cuda.stream(stream):
        dev = groups_to_device(groups, device, non_blocking=True)
        copied = torch.cuda.Event()
        copied.record(stream)
    return dev, copied


class _Mode:
    """Installs one mode's host-side setting for the length of a run."""

    def __init__(self, mode):
        self.mode = mode

    def __enter__(self):
        import torch
        from repro_torch.core import executor, prefetch
        self.event, self.interval = torch.cuda.Event, sys.getswitchinterval()
        self.begin, self.stage = (executor.PipelinedExecutor._begin_pass,
                                  prefetch.stage_groups)
        if self.mode == "pipelined-no-demand":
            begin = self.begin

            def no_demand(ex, tier):
                out = begin(ex, tier)
                ex._demand_active = False
                return out
            executor.PipelinedExecutor._begin_pass = no_demand
        if self.mode == "pipelined-issue":
            prefetch.stage_groups = _stage_no_wait
        if self.mode == "pipelined-yield":
            real = self.event
            torch.cuda.Event = lambda *a, **kw: real(
                *a, **{**kw, "blocking": True})
        if self.mode == "pipelined-switch":
            sys.setswitchinterval(0.0005)
        return self

    def __exit__(self, *exc):
        import torch
        from repro_torch.core import executor, prefetch
        executor.PipelinedExecutor._begin_pass = self.begin
        prefetch.stage_groups = self.stage
        torch.cuda.Event = self.event
        sys.setswitchinterval(self.interval)
        return False


def run_modes(tag, cfg, params, db, system, budget, modes, n_rounds,
              **kw):
    """``n_rounds`` rounds of ``modes``; the rows, after checking that
    every run gave the same tokens."""
    rows, tokens = [], None
    for r in range(n_rounds):
        for mode in modes:
            with _Mode(mode):
                run = cs.serve_once(cfg, params, db, system, budget,
                                    overlap=mode != "sync", **kw)
            row = cs.summarise(f"{tag} {mode} round {r}", run)
            run["sess"].close()
            if tokens is None:
                tokens = run["tokens"]
            elif run["tokens"] != tokens:
                raise AssertionError(f"{tag} {mode} round {r}: tokens "
                                     "differ")
            rows.append({"model": tag, "mode": mode, "round": r,
                         **{k: row[k] for k in (
                             "decode_tps", "decode_step_ms", "ttft_s")}})
            del run
            cs.free_cuda()
    cs.log(f"{tag}: tokens identical across every mode and round: True")
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--after-profiler", action="store_true")
    ap.add_argument("--moe", action="store_true")
    ap.add_argument("--moe-modes", default=",".join(MODES[:2]))
    args = ap.parse_args()
    unknown = set(args.moe_modes.split(",")) - set(MOE_MODES)
    if unknown:
        ap.error(f"unknown modes {sorted(unknown)}; known: {MOE_MODES}")
    import torch
    if not torch.cuda.is_available():
        print("copy_modes: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(cs.SRC))
    from repro_torch.configs import get_config
    from repro_torch.core import SYSTEMS, build_graph, run_install, \
        total_weight_bytes
    from repro_torch.core.executor import pin_host_tree
    from repro_torch.models import build_model
    card = cs.card_line()
    cs.log(card)
    if args.after_profiler:
        x = torch.randn((256, 256), device="cuda")
        cs.profiled(lambda: [x @ x for _ in range(10)])
        cs.log("ran one torch.profiler window first")
    link = cs.measure_link_gbps()
    system = SYSTEMS["h100"].with_(link_gbps=link)
    cfg = get_config("qwen2-0.5b")
    params = pin_host_tree(build_model(cfg).init(
        torch.Generator().manual_seed(0)), torch.device("cuda"))
    db = run_install(system)
    budget = int(total_weight_bytes(build_graph(cfg)) * 0.1)
    warm = cs.serve_once(cfg, params, db, system, budget, n_req=1,
                         new_tokens=2)
    warm["sess"].close()
    del warm
    rows = run_modes("qwen2-0.5b", cfg, params, db, system, budget, MODES,
                     args.rounds)
    del params
    cs.free_cuda()
    if args.moe:
        cfg = get_config(cs.MOE_ARCH).replace(n_layers=cs.MOE_LAYERS)
        params = cs.moe_host_params(cfg)
        budget = int(total_weight_bytes(build_graph(
            cfg, expert_granular=True)) * 0.1)
        warm = cs.serve_once(cfg, params, db, system, budget, n_req=1,
                             new_tokens=2)
        warm["sess"].close()
        del warm
        rows += run_modes(cs.MOE_ARCH, cfg, params, db, system, budget,
                          args.moe_modes.split(","), args.rounds)
    print(json.dumps({"card": card, "link_gbps": link,
                      "after_profiler": args.after_profiler,
                      "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
