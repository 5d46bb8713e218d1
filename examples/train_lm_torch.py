"""PyTorch twin of ``train_lm.py``: train an LM end-to-end with the
fault-tolerant driver — checkpointing, restart-on-failure, straggler
watch, deterministic data replay — on the CUDA card unless ``--device
cpu``.

Default is a quick run; ``--preset 100m --steps 300`` is the full
~100M-parameter configuration (same code path, longer wall-clock). Above
2048 tokens (``--seq``) every layer's attention runs through the
hand-written flash attention kernel, forward and backward.

    PYTHONPATH=src python examples/train_lm_torch.py [--steps 60]
    PYTHONPATH=src python examples/train_lm_torch.py --preset 100m \\
        --seq 4096 --batch 2 --steps 30
    PYTHONPATH=src python examples/train_lm_torch.py --device cpu

The step runs eagerly (no ``jit``); the checkpoints default to a directory
of their own under the system's temporary directory, apart from the
reference's.
"""
import argparse
import os
import tempfile

import torch

from repro_torch.config import ModelConfig
from repro_torch.configs import get_smoke_config
from repro_torch.data import DataPipeline
from repro_torch.device import resolve_device
from repro_torch.launch.steps import make_train_step
from repro_torch.models import build_model
from repro_torch.models.common import tree_leaves
from repro_torch.optim import OptConfig, adamw_init
from repro_torch.runtime import FaultInjector, TrainDriver


def preset_cfg(name):
    if name == "100m":
        return ModelConfig(
            name="lm-100m", family="dense", n_layers=12, d_model=768,
            n_heads=12, n_kv_heads=4, d_ff=2048, vocab=32000, head_dim=64,
            mlp="swiglu", pos="rope")
    return get_smoke_config("yi-9b")


def main(argv=None):
    """Parse ``argv`` (``sys.argv[1:]`` when None), train, print the
    reference's lines and return what they show: the parameter count,
    every completed step's metrics (replayed steps again), the events and
    each step's seconds."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="smoke", choices=["smoke", "100m"])
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_lm_ckpt"))
    ap.add_argument("--inject-fault", type=int, default=25,
                    help="step at which to inject a failure (-1: none)")
    ap.add_argument("--device", default=None,
                    help="'cpu' to train on the host (default: the card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = preset_cfg(args.preset)
    model = build_model(cfg)
    params = model.init(torch.Generator(device=device).manual_seed(0))
    n = sum(x.numel() for x in tree_leaves(params))
    print(f"model {cfg.name}: {n/1e6:.1f}M params")
    oc = OptConfig(lr=3e-3, warmup_steps=10, total_steps=args.steps,
                   weight_decay=0.0)
    step = make_train_step(cfg, oc=oc, remat="none")

    def step_fn(state, batch):
        b = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
        p, o, metrics = step(state["params"], state["opt"], b)
        return {"params": p, "opt": o}, metrics

    pipe = DataPipeline(cfg, args.seq, args.batch, seed=0,
                        process_index=0, process_count=1)
    faults = FaultInjector([args.inject_fault] if args.inject_fault >= 0
                           else [])
    drv = TrainDriver(step_fn, {"params": params,
                                "opt": adamw_init(oc, params)},
                      pipe, args.ckpt_dir, ckpt_every=20,
                      fault_injector=faults)
    log = drv.run(args.steps)
    for i in range(0, len(log), max(1, len(log) // 10)):
        print(f"step {i:4d}: loss {log[i]['loss']:.4f} "
              f"lr {log[i]['lr']:.2e} gnorm {log[i]['grad_norm']:.2f}")
    print(f"final loss {log[-1]['loss']:.4f} (first {log[0]['loss']:.4f})")
    print(f"runtime events: {drv.events}")
    return {"arch": cfg.name, "n_params": n, "log": log,
            "events": list(drv.events), "step_seconds": drv.step_seconds,
            "steps": drv.step}


if __name__ == "__main__":
    main()
