"""PyTorch twin of ``serve_vram_budget.py``: serve batched requests under a
VRAM budget with pipelined sharding — plan, chunk-prefill, decode — through
the ``repro_torch.Session`` front door, including a live mid-serve
``update_budget`` swap (the IGI "game claimed the VRAM" scenario,
DESIGN.md §8).

On the CUDA card the weights that do not fit the budget live in pinned host
memory and cross PCIe one sub-layer ahead of compute; every FFN matmul (and
every expert's, for an MoE model) runs through the hand-written streamed
matmul kernel. ``--device cpu`` runs the plain versions on the host, where
both tiers are simulated as in the reference. The generated tokens are
verified to be identical across budgets AND across the live swap.

    PYTHONPATH=src python examples/serve_vram_budget_torch.py [--arch qwen30b-a3b]
    PYTHONPATH=src python examples/serve_vram_budget_torch.py --arch qwen2-0.5b --full
    PYTHONPATH=src python examples/serve_vram_budget_torch.py --device cpu

``--full`` serves the published config in place of the smoke one.
"""
import argparse
import time

from repro_torch import Session
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core import CLI2, InferenceSetting, build_graph, run_install
from repro_torch.core.serving import random_requests
from repro_torch.device import resolve_device


def make_requests(cfg, batch, prompt_len, new_tokens, seed=1):
    return random_requests(cfg.vocab, batch, prompt_len, new_tokens,
                           seed=seed)


def main(argv=None):
    """Parse ``argv`` (``sys.argv[1:]`` when None), serve, print the
    reference's lines and return what they show: one row per budget and
    the live re-budget's."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen30b-a3b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=24)
    ap.add_argument("--new-tokens", type=int, default=8)
    ap.add_argument("--full", action="store_true",
                    help="the published config in place of the smoke one")
    ap.add_argument("--device", default=None,
                    help="'cpu' to run on the host (default: the card)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch) if args.full else get_smoke_config(args.arch)
    if cfg.family not in ("dense", "moe"):
        raise ValueError("serving demo covers dense/moe")
    db = run_install(CLI2, quick=True)
    total = sum(s.weight_bytes for s in build_graph(cfg, wdtype=2))
    setting = InferenceSetting(batch=args.batch, context=128)

    ref_tokens = None
    rows = []
    for frac in (2.0, 0.5, 0.1):
        sess = Session.open(cfg, CLI2, int(total * frac) + 1, setting,
                            db=db, max_seq=128, device=device)
        reqs = make_requests(cfg, args.batch, args.prompt_len,
                             args.new_tokens)
        t0 = time.perf_counter()
        sess.serve(reqs, max_batch=args.batch)
        dt = time.perf_counter() - t0
        st = sess.stats()
        sess.close()
        gen = [list(r.generated) for r in reqs]
        if ref_tokens is None:
            ref_tokens = gen
        same = gen == ref_tokens
        rows.append({"budget": frac, "served_s": dt, "tokens": gen,
                     "streamed_bytes": st["executor"]["streamed_bytes"],
                     "engine_calls": st["executor"]["engine_calls"],
                     "identical": same})
        print(f"budget={frac:4.1f}x weights ({total*frac/1e6:7.1f}MB): "
              f"served {args.batch} reqs in {dt*1e3:7.1f}ms "
              f"| streamed {st['executor']['streamed_bytes']/1e6:7.1f}MB, "
              f"engines {st['executor']['engine_calls']}, "
              f"tokens identical across budgets: {same}")

    # live swap: start at 2x, drop to 0.1x with requests IN FLIGHT —
    # in-flight slots keep decoding, and only the pin/evict delta moves
    sess = Session.open(cfg, CLI2, int(total * 2.0) + 1, setting,
                        db=db, max_seq=128, device=device)
    reqs = make_requests(cfg, args.batch, args.prompt_len, args.new_tokens)
    sess.serve(reqs, max_batch=args.batch, max_iterations=2)
    diff = sess.update_budget(int(total * 0.1) + 1)
    sess.serve([])  # drain the in-flight slots under the new schedule
    sess.close()
    same = [list(r.generated) for r in reqs] == ref_tokens
    print(f"live rebudget 2.0x -> 0.1x mid-serve: moved "
          f"{diff.moved_bytes/1e6:.2f}MB ({diff.summary()}); "
          f"remaining tokens identical to uninterrupted runs: {same}")
    where = ("this container's CPU simulating both tiers"
             if device.type == "cpu" else
             f"the card ({device}) with pinned host memory over PCIe")
    print(f"NOTE: wall-clock here is {where}; the schedule choices + "
          "streamed bytes are the signal. Planner estimates for real "
          "client systems: benchmarks/table4.csv")
    return {"arch": cfg.name, "weight_bytes": total, "rows": rows,
            "rebudget": {"moved_bytes": diff.moved_bytes,
                         "summary": diff.summary(),
                         "tokens": [list(r.generated) for r in reqs],
                         "identical": same}}


if __name__ == "__main__":
    main()
