"""Training launcher: the fault-tolerant driver around a train step, on
the CUDA card unless ``--device cpu``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \\
        --full --seq 4096 --batch 4 --steps 8 --remat full
    PYTHONPATH=src python -m repro_torch.launch.train --arch yi-9b \\
        --steps 60 --device cpu

The default is the arch's smoke config; ``--full`` trains the published
config on one card: no device mesh and no ``jax.distributed`` (the
reference's ``--full`` initialises both and shards the step over a pod).
Weights are drawn from seed 0 on the device, the data is
``DataPipeline``'s synthetic stream from seed 0, and the optimizer is
AdamW with no weight decay, warming up over ``--warmup`` steps (the
reference's 10) and decaying to 0 at ``--steps``.
"""
from __future__ import annotations

import argparse
import os
import tempfile

import torch

from repro_torch.configs import get_config, get_smoke_config, list_archs
from repro_torch.data import DataPipeline
from repro_torch.device import resolve_device
from repro_torch.launch.steps import make_train_step
from repro_torch.models import build_model
from repro_torch.optim import OptConfig, adamw_init
from repro_torch.runtime import FaultInjector, TrainDriver


def main(argv=None):
    """Parse ``argv`` (``sys.argv[1:]`` when None), train, print one
    summary line and return the ``TrainDriver`` (its ``metrics_log``,
    ``events``, ``step_seconds`` and final ``state``)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="yi-9b",
                    choices=list_archs(include_paper=True))
    ap.add_argument("--full", action="store_true",
                    help="the published config on one card (no device "
                         "mesh, no jax.distributed: the reference's pod "
                         "entry point shards this step over a mesh)")
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--warmup", type=int, default=10,
                    help="linear warmup steps of the cosine schedule")
    ap.add_argument("--remat", default="none",
                    choices=["none", "full", "dots"])
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train"))
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--inject-fault", type=int, default=-1)
    ap.add_argument("--device", default=None,
                    help="'cpu' to train on the host (default: the card)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch) if args.full else get_smoke_config(args.arch)
    model = build_model(cfg)
    params = model.init(torch.Generator(device=device).manual_seed(0))
    oc = OptConfig(lr=args.lr, warmup_steps=args.warmup,
                   total_steps=args.steps, weight_decay=0.0)
    step = make_train_step(cfg, oc=oc, remat=args.remat)

    def step_fn(state, batch):
        b = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
        p, o, metrics = step(state["params"], state["opt"], b)
        return {"params": p, "opt": o}, metrics

    pipe = DataPipeline(cfg, args.seq, args.batch, seed=0)
    faults = FaultInjector([args.inject_fault] if args.inject_fault >= 0
                           else [])
    drv = TrainDriver(step_fn, {"params": params,
                                "opt": adamw_init(oc, params)},
                      pipe, args.ckpt_dir, ckpt_every=args.ckpt_every,
                      fault_injector=faults)
    log = drv.run(args.steps)
    print(f"[train] {cfg.name}: loss {log[0]['loss']:.4f} -> "
          f"{log[-1]['loss']:.4f} over {args.steps} steps; "
          f"events={drv.events}")
    return drv


if __name__ == "__main__":
    main()
