"""Serving launcher — the Session façade as the first-class entry point.

Opens a planning-only ``repro_torch.Session`` for the full model against
the VRAM budget (install-phase profile + the planner's tier table), prints
the decode and prefill plans and the planner's TTFT / TPS estimates, then
opens an executing Session at smoke scale and serves batched requests
through it, with a live ``update_budget`` swap mid-run (the mid-session
VRAM-pressure scenario). The audio, hybrid and ssm families are
planning-only: their sessions plan but do not execute.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-7b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-0.5b \\
        --device cpu

The smoke-scale serve runs on the CUDA card unless ``--device cpu``.
"""
from __future__ import annotations

import argparse
import time

from repro_torch import Session
from repro_torch.configs import get_config, get_smoke_config, list_archs
from repro_torch.core import SYSTEMS, InferenceSetting, build_graph, \
    run_install
from repro_torch.core.serving import random_requests


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen30b-a3b",
                    choices=list_archs(include_paper=True))
    ap.add_argument("--hbm-budget-gb", type=float, default=4.0)
    ap.add_argument("--system", default="h100", choices=sorted(SYSTEMS))
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--context", type=int, default=4096)
    ap.add_argument("--prompt-len", type=int, default=24)
    ap.add_argument("--new-tokens", type=int, default=8)
    ap.add_argument("--device", default=None,
                    help="'cpu' to serve on the host (default: the card)")
    args = ap.parse_args(argv)

    system = SYSTEMS[args.system]
    budget = int(args.hbm_budget_gb * 1e9)
    db = run_install(system, quick=True)

    # ---- plan the FULL model against the budget (planning-only Session:
    # no weights are ever allocated)
    full = get_config(args.arch)
    plan = Session.open(full, system, budget,
                        InferenceSetting(batch=args.batch,
                                         context=args.context), db=db,
                        device=args.device)
    sched = plan.schedule
    print(f"[serve] {full.name} ({full.param_count()/1e9:.1f}B) @ "
          f"{args.hbm_budget_gb}G on {system.name}: "
          f"pinned {sched.pinned_bytes/1e9:.2f}G "
          f"scratch {sched.scratch_bytes/1e9:.2f}G")
    for tokens, label in ((args.batch, "decode"), (args.context, "prefill")):
        t = sched.pick_tier(tokens)
        print(f"[serve]   {label:7s}: tier {t:5d} plan "
              f"{sched.tiers[t].plan.name}")
    est = plan.estimates(args.context)
    print(f"[serve]   est TTFT({args.context}) {est['ttft_s']:.2f}s | "
          f"est TPS {est['tps']:.1f}")

    # ---- execute for real at reduced scale
    cfg = get_smoke_config(args.arch)
    if cfg.family not in ("dense", "moe"):
        print("[serve] executor demo covers dense/moe; planning-only for "
              f"family {cfg.family}")
        return
    stotal = sum(s.weight_bytes for s in build_graph(cfg, wdtype=2))
    sbudget = max(int(stotal * args.hbm_budget_gb / system.vram_gb), 1)
    sess = Session.open(cfg, system, sbudget,
                        InferenceSetting(batch=args.batch, context=128),
                        db=db, max_seq=128, device=args.device)
    reqs = random_requests(cfg.vocab, args.batch, args.prompt_len,
                           args.new_tokens, seed=1)
    t0 = time.perf_counter()
    sess.serve(reqs, max_batch=args.batch)
    dt = time.perf_counter() - t0
    st = sess.stats()
    print(f"[serve] smoke-scale serving: {args.batch} requests x "
          f"{args.new_tokens} tokens in {dt:.2f}s | streamed "
          f"{st['executor']['streamed_bytes']/1e6:.1f}MB, engines "
          f"{st['executor']['engine_calls']}, aggregate TPS "
          f"{st['serving']['aggregate_tps']:.1f}")
    print(f"[serve] sample continuation: {reqs[0].generated}")

    # ---- live re-plan: another program claimed half the VRAM mid-session
    diff = sess.update_budget(max(sbudget // 2, 1))
    more = random_requests(cfg.vocab, args.batch, args.prompt_len,
                           args.new_tokens, seed=2, rid_base=100)
    sess.serve(more)
    print(f"[serve] rebudget to {args.hbm_budget_gb/2:.1f}G-equivalent: "
          f"moved only {diff.moved_bytes/1e6:.2f}MB "
          f"({diff.summary()}); serving continued")


if __name__ == "__main__":
    main()
