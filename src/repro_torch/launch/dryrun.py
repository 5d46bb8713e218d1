"""Per-cell counts on one card: what each ``(arch, shape)`` cell of
``config.cells()`` costs, without allocating it.

The reference's dry-run lowers each cell on its 16x16 mesh and keeps XLA's
``memory_analysis`` and ``cost_analysis``. The port runs eagerly on one
card, so it counts instead (``launch/counting.py``): the step the shape's
kind dictates (``make_train_step`` with remat ``REPRO_REMAT``, default
``"full"``, and ``REPRO_MICROBATCHES``, default 1; ``make_prefill_step``;
``make_decode_step``) runs at full width and depth on fake tensors
(``models/api.py``'s specs), so nothing is allocated and a cell of any
size is counted on the host. Each cell's whole shape is one card's
(``n_chips: 1``). The record keeps the reference's ``memory`` keys:

- ``argument_bytes``, ``output_bytes``: the step's inputs and outputs;
- ``alias_bytes``: outputs that take the place of a donated input: the
  new params and optimizer state of a train step (eagerly they are
  written while the old ones are alive, which the peak counts), the
  cache of a serving step (written in place);
- ``temp_bytes``: the peak of live bytes less the arguments;
- ``host_argument_bytes``: the optimizer state that ``offload_opt`` keeps
  off the card (a count only: no runtime path offloads it, as the
  reference only compiles that path); ``host_temp_bytes``: 0;
- ``per_chip_peak_bytes``: the peak of live bytes less the host's
  arguments, which ``fits_card`` compares with the card's 80 GB.

plus ``flops_per_chip`` and ``bytes_per_chip`` (the counts),
``model_flops_per_chip`` (the reference's analytic count, at one chip),
the kernel wrappers' hand counts and ``collectives`` (none on one card).
None of the reference's XLA environment variables is set.

Usage:
    python -m repro_torch.launch.dryrun --arch qwen2-0.5b --shape decode_32k
    python -m repro_torch.launch.dryrun --all        # every cell, each in a
                                                     # subprocess
    python -m repro_torch.launch.dryrun --table      # the records, as markdown
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import traceback
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from repro_torch.config import SHAPES, cells
from repro_torch.configs import get_config
from repro_torch.launch import counting
from repro_torch.launch.steps import (make_decode_step, make_prefill_step,
                                      make_train_step)
from repro_torch.models.api import input_specs, param_specs, spec_mode
from repro_torch.models.common import tree_leaves
from repro_torch.optim import OptConfig, adamw_init

RESULTS_DIR = Path(__file__).resolve().parents[3] / "benchmarks" / \
    "results" / "dryrun_torch"
CELL_TIMEOUT_S = 7200

# Per-arch training memory knobs, as the reference's: the >= 100B MoE
# cells keep bf16 optimizer state; the 1T model also keeps it off the card
ARCH_OVERRIDES = {
    "kimi-k2-1t-a32b": {"state_dtype": "bfloat16", "offload_opt": True},
    "qwen3-moe-235b-a22b": {"state_dtype": "bfloat16", "offload_opt": False},
}


def default_device() -> str:
    """``"cuda"`` where the build has CUDA, else ``"cpu"``: a CPU-only
    build cannot run autograd on a fake CUDA tensor."""
    return "cuda" if torch.cuda.is_available() else "cpu"


# ------------------------------------------------ the reference's analytic count
def active_param_count(cfg) -> float:
    if cfg.moe is None:
        return float(cfg.param_count())
    m = cfg.moe
    expert = cfg.n_layers * m.n_experts * 3 * cfg.d_model * m.d_expert
    active = cfg.n_layers * m.top_k * 3 * cfg.d_model * m.d_expert
    return float(cfg.param_count() - expert + active)


def n_attn_layers(cfg) -> int:
    if cfg.family == "hybrid":
        return cfg.n_layers // max(cfg.shared_attn_every, 1)
    if cfg.family == "ssm":
        return 0
    return cfg.n_layers


def model_flops(cfg, shape) -> float:
    """``benchmarks/roofline.py::model_flops_per_chip`` at one chip: 2 (6
    for train) x active params x tokens, plus the attention's products
    (causal ~T^2/2 pairs, two products, 2 flops each; x3 for train)."""
    gb, T = shape.global_batch, shape.seq_len
    hd, H = cfg.resolved_head_dim, cfg.n_heads
    if shape.kind == "decode":
        tokens = gb
        attn = n_attn_layers(cfg) * gb * 2 * 2 * T * H * hd
        mult = 2
    else:
        tokens = gb * T
        attn = n_attn_layers(cfg) * gb * 2 * T * T * H * hd
        mult = 6 if shape.kind == "train" else 2
        if shape.kind == "train":
            attn *= 3
    return mult * active_param_count(cfg) * tokens + attn


# ------------------------------------------------------------ one cell
def build_cell(cfg, shape, device, arch=None):
    """(step, arguments, call arguments, the argument trees an output
    replaces, the arguments kept on the host) for ``cfg`` at ``shape`` on
    fake tensors. Decode's ``pos`` is a 0-dim int32 argument, as the
    reference's; the step reads it as the int the port's decode takes
    (the last position of the cache)."""
    ov = ARCH_OVERRIDES.get(arch or cfg.name, {})
    params = param_specs(cfg, device)
    specs = input_specs(cfg, shape, device)
    if shape.kind == "train":
        oc = OptConfig(state_dtype=ov.get("state_dtype", "float32"))
        with spec_mode():
            opt = adamw_init(oc, params)
        step = make_train_step(
            cfg, oc, remat=os.environ.get("REPRO_REMAT", "full"),
            microbatches=int(os.environ.get("REPRO_MICROBATCHES", "1")))
        args = (params, opt, specs["batch"])
        host = opt if ov.get("offload_opt") else None
        return step, args, args, "train", host
    if shape.kind == "prefill":
        args = (params, specs["batch"], specs["cache"])
        return make_prefill_step(cfg), args, args, "cache", None
    args = (params, specs["batch"], specs["cache"], specs["pos"])
    return (make_decode_step(cfg), args, args[:3] + (shape.seq_len - 1,),
            "cache", None)


def count_cell(arch, shape_name, device=None, n_layers=None, cfg=None):
    """Count ``arch``'s step at ``shape_name`` (or a ``ShapeConfig``) on
    fake tensors (full depth, or ``n_layers``; ``cfg`` in place of
    ``arch``'s published config):
    (the ``Count``, its host seconds, the optimizer bytes kept on the
    host, the train step's donated output bytes)."""
    cfg = cfg or get_config(arch)
    if n_layers is not None:
        cfg = cfg.replace(n_layers=n_layers)
    device = device or default_device()
    t0 = time.perf_counter()
    shape = SHAPES[shape_name] if isinstance(shape_name, str) \
        else shape_name
    step, args, call, kind, host = build_cell(cfg, shape, device, arch)
    with counting.count_step(*args) as rec:
        out = rec.outputs(step(*call))
        donated = sum(counting.nbytes(t) for t in tree_leaves(
            {"p": out[0], "o": out[1]})) if kind == "train" else None
        del out
    host_bytes = 0 if host is None else sum(
        counting.nbytes(t) for t in tree_leaves(host))
    return rec, time.perf_counter() - t0, host_bytes, donated


def run_cell(arch, shape_name, save=True, device=None):
    """One cell's record (see the module docstring); written under
    ``RESULTS_DIR`` when ``save``."""
    device = device or default_device()
    shape = SHAPES[shape_name]
    rec, secs, host_bytes, donated = count_cell(arch, shape_name, device)
    cfg = get_config(arch)
    peak = rec.peak_live_bytes - host_bytes
    result = {
        "arch": arch, "shape": shape_name, "kind": shape.kind,
        "n_chips": 1, "device": device, "fake": rec.fake,
        "count_seconds": secs,
        "memory": {
            "argument_bytes": rec.argument_bytes,
            "output_bytes": rec.output_bytes,
            "temp_bytes": rec.peak_live_bytes - rec.argument_bytes,
            "alias_bytes": rec.alias_bytes if donated is None else donated,
            "host_argument_bytes": host_bytes,
            "host_temp_bytes": 0,
            "per_chip_peak_bytes": peak,
        },
        "flops_per_chip": rec.flops,
        "bytes_per_chip": rec.bytes_accessed,
        "model_flops_per_chip": model_flops(cfg, shape),
        "kernels": rec.kernels,
        "n_ops": rec.n_ops,
        "peak_by_op": dict(sorted(rec.peak_tags.items(),
                                  key=lambda kv: -kv[1])[:6]),
        "collectives": dict(counting.COLLECTIVES),
        "fits_card": peak <= counting.CARD_BYTES,
        "card_bytes": counting.CARD_BYTES,
    }
    print(f"[dryrun] {arch} x {shape_name}: counted in {secs:.1f}s, "
          f"args {rec.argument_bytes / 1e9:.2f}GB, peak "
          f"{peak / 1e9:.2f}GB (fits one card: {result['fits_card']}), "
          f"flops {rec.flops:.3e} (model {result['model_flops_per_chip']:.3e}),"
          f" bytes {rec.bytes_accessed:.3e}", flush=True)
    if save:
        RESULTS_DIR.mkdir(parents=True, exist_ok=True)
        with open(RESULTS_DIR / f"{arch}__{shape_name}.json", "w") as f:
            json.dump(result, f, indent=1)
    return result


def _run_one(module, out_dir, arch, shape_name, stdout_tail=4000):
    """``python -m module --arch A --shape S`` in a subprocess of its own,
    under ``CELL_TIMEOUT_S``; a failure or a hang writes
    ``out_dir/<arch>__<shape>.FAILED`` with the tail of the child's stdout
    (its last ``stdout_tail`` characters) and stderr. Returns (tag, ok,
    the child's last line, or the tag where it printed none). The dry-run
    and the probe sweep through it."""
    tag = f"{arch}__{shape_name}"
    cmd = [sys.executable, "-m", module, "--arch", arch, "--shape",
           shape_name]
    src = str(Path(__file__).resolve().parents[2])
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        p for p in (src, os.environ.get("PYTHONPATH")) if p)}
    try:
        r = subprocess.run(cmd, capture_output=True, text=True, env=env,
                           timeout=CELL_TIMEOUT_S)
        ok = r.returncode == 0
        log = r.stdout[-stdout_tail:] + "\n" + r.stderr[-8000:]
        line = r.stdout.strip().splitlines()[-1] if r.stdout.strip() else tag
    except subprocess.TimeoutExpired:
        ok, log, line = False, f"timed out after {CELL_TIMEOUT_S} s", tag
    if not ok:
        with open(Path(out_dir) / f"{tag}.FAILED", "w") as f:
            f.write(log)
    return tag, ok, line


def sweep(only_failed=False, jobs=1):
    """Every cell in a subprocess of its own (a failure or a hang stays in
    its cell), ``jobs`` at a time, each under ``CELL_TIMEOUT_S``."""
    RESULTS_DIR.mkdir(parents=True, exist_ok=True)
    todo = [(a, s) for a, s in cells()
            if not (only_failed and (RESULTS_DIR / f"{a}__{s}.json").exists())]
    with ThreadPoolExecutor(max_workers=jobs) as pool:
        results = list(pool.map(
            lambda c: _run_one("repro_torch.launch.dryrun", RESULTS_DIR, *c),
            todo))
    failures = [tag for tag, ok, line in results if not ok]
    for tag, ok, line in results:
        print(line if ok else f"[dryrun] FAIL {tag} (log: {tag}.FAILED)")
    print(f"[dryrun] sweep done; {len(failures)} failures: {failures}")
    return failures


def table():
    """The records under ``RESULTS_DIR`` as a markdown table, in
    ``config.cells()``'s order (a cell without a record says so)."""
    lines = ["| arch | shape | flops | model flops | bytes | per-card peak B "
             "| fits one card | host s |", "|" + " --- |" * 8]
    for arch, shape in cells():
        path = RESULTS_DIR / f"{arch}__{shape}.json"
        if not path.exists():
            lines.append(f"| {arch} | {shape} | no record |" + " |" * 5)
            continue
        r = json.loads(path.read_text())
        lines.append(
            f"| {arch} | {shape} | {r['flops_per_chip']:.4e} | "
            f"{r['model_flops_per_chip']:.4e} | {r['bytes_per_chip']:.4e} | "
            f"{r['memory']['per_chip_peak_bytes']:.4e} | "
            f"{'yes' if r['fits_card'] else 'no'} | "
            f"{r['count_seconds']:.1f} |")
    return "\n".join(lines)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--only-failed", action="store_true")
    ap.add_argument("--jobs", type=int, default=1,
                    help="cells counted at once by --all")
    ap.add_argument("--table", action="store_true",
                    help="print the records as a markdown table")
    args = ap.parse_args()
    if args.table:
        print(table())
        return
    if args.all:
        sys.exit(1 if sweep(args.only_failed, args.jobs) else 0)
    try:
        run_cell(args.arch, args.shape)
    except Exception:
        traceback.print_exc()
        sys.exit(1)


if __name__ == "__main__":
    main()
