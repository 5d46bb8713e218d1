"""PyTorch twin of ``quickstart.py``: open a ``repro_torch.Session``, plan a
VRAM budget, generate — on the CUDA card unless ``--device cpu``.

    PYTHONPATH=src python examples/quickstart_torch.py [--arch yi-9b]
    PYTHONPATH=src python examples/quickstart_torch.py --arch qwen2-0.5b --full
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu

Step [1] plans the published config; steps [2] and [3] generate with the
smoke config, or with the published one under ``--full``. On the card
every FFN matmul of a generation runs through the hand-written streamed
matmul kernel.
"""
import argparse

import numpy as np

from repro_torch import Session
from repro_torch.configs import get_config, get_smoke_config, list_archs
from repro_torch.core import CLI3, InferenceSetting, build_graph
from repro_torch.device import resolve_device


def main(argv=None):
    """Parse ``argv`` (``sys.argv[1:]`` when None), plan and generate, print
    the reference's lines and return what they show."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="yi-9b",
                    choices=list_archs(include_paper=True))
    ap.add_argument("--budget-gb", type=float, default=8.0)
    ap.add_argument("--full", action="store_true",
                    help="generate with the published config in place of "
                         "the smoke one")
    ap.add_argument("--device", default=None,
                    help="'cpu' to run on the host (default: the card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    # 1. plan the FULL config at a budget (planning-only Session: the
    #    install-phase profile runs, no weights are allocated)
    full = get_config(args.arch)
    plan = Session.open(full, CLI3, int(args.budget_gb * 1e9),
                        InferenceSetting(batch=1, context=4096),
                        device=device)
    sched = plan.schedule
    print(f"[1] {full.name} ({full.param_count()/1e9:.1f}B) at "
          f"{args.budget_gb}G budget:")
    print(f"    pinned {sched.pinned_bytes/1e9:.2f}G, "
          f"scratch {sched.scratch_bytes/1e9:.2f}G")
    tiers = {}
    for tier in (1, 512, 4096):
        e = sched.tiers[tier]
        tiers[tier] = {"plan": e.plan.name, "est_time_s": e.est_time}
        print(f"    tier {tier:5d}: plan={e.plan.name:9s} "
              f"est {e.est_time*1e3:8.2f} ms/iter")
    est = plan.estimates(4096)
    print(f"    est TTFT(4k prompt) {est['ttft_s']:6.2f}s | "
          f"est TPS {est['tps']:6.1f}")
    out = {"arch": full.name, "pinned_bytes": sched.pinned_bytes,
           "scratch_bytes": sched.scratch_bytes, "tiers": tiers,
           "ttft_s": est["ttft_s"], "tps": est["tps"]}

    # 2. a real generation (a reduced config unless --full): same Session
    #    API, executor built lazily on first generate()
    cfg = get_config(args.arch) if args.full else get_smoke_config(args.arch)
    if cfg.family not in ("dense", "moe"):
        print(f"[2] family {cfg.family}: planning-only (executor covers "
              "dense/moe)")
        return out
    total = sum(s.weight_bytes for s in build_graph(cfg, wdtype=2))
    sess = Session.open(cfg, CLI3, int(total * 2.0) + 1,
                        InferenceSetting(batch=2, context=128),
                        db=plan.db, max_seq=128, device=device)
    prompts = np.random.RandomState(1).randint(0, cfg.vocab, (2, 16))
    gen = sess.generate(prompts, max_new_tokens=8)
    print(f"[2] {cfg.name}: generated {gen.shape} tokens; sample "
          f"{gen[0].tolist()}")

    # 3. live re-plan: shrink the budget 20x mid-session; only the
    #    pin/evict delta moves (Schedule.diff == executor rebind, §8)
    diff = sess.update_budget(int(total * 0.1) + 1)
    gen2 = sess.generate(prompts, max_new_tokens=8)
    sess.close()
    same = bool(np.array_equal(gen, gen2))
    print(f"[3] rebudget 2.0x -> 0.1x weights: moved "
          f"{diff.moved_bytes/1e6:.2f}MB ({diff.summary()})")
    print(f"    tokens identical across budgets: {same}")
    out.update({"generated": gen.tolist(), "regenerated": gen2.tolist(),
                "moved_bytes": diff.moved_bytes, "summary": diff.summary(),
                "identical": same})
    return out


if __name__ == "__main__":
    main()
