"""Per-layer costs of a cell from counts at two reduced depths.

The reference's probe exists because XLA counts a scanned layer once: it
lowers the step at two depths with the scans unrolled and reconstructs

    per_layer = (cost(L2) - cost(L1)) / (L2 - L1)
    total     = cost(L1) - per_layer * L1  +  per_layer * n_layers

The port runs eagerly, with no scan, so ``launch/dryrun.py`` can count at
full depth; this probe earns its place by cost: a fake count takes the
host about 0.6 s a layer, and a per-layer extrapolation from two shallow
counts costs a few layers however deep the model (kimi-k2-1t-a32b: 61
layers of 384 experts). Where the layers repeat, the extrapolation equals
the full-depth count exactly (kept as a fraction, so no rounding enters).
The record gives the reference's ``*_fixed`` and ``*_per_layer`` fields
for flops, bytes and collectives (0 on one card).

Usage:
    python -m repro_torch.launch.probe --arch yi-9b --shape train_4k
    python -m repro_torch.launch.probe --all            # every cell, each
                                                        # in a subprocess
    python -m repro_torch.launch.probe --all --only-failed   # cells with
                                                             # no record
"""
from __future__ import annotations

import argparse
import json
import sys
import traceback
from fractions import Fraction

from repro_torch.config import cells
from repro_torch.configs import get_config
from repro_torch.launch.dryrun import RESULTS_DIR, _run_one, count_cell

PROBE_DIR = RESULTS_DIR.parent / "probe_torch"


def depth_pair(cfg):
    """Two reduced depths whose difference isolates one layer (or group)."""
    if cfg.family == "hybrid":
        per = cfg.shared_attn_every
        return per, 2 * per, cfg.n_layers / per  # group-granular
    if cfg.family == "ssm":
        return 2, 4, cfg.n_layers / 2  # pair-granular
    return 1, 2, float(cfg.n_layers)


def _cost_at_depth(arch, shape_name, depth, device, cfg):
    rec = count_cell(arch, shape_name, device, n_layers=depth, cfg=cfg)[0]
    return {"flops": rec.flops, "bytes": rec.bytes_accessed, "coll": 0}


def _exact(x: Fraction):
    return int(x) if x.denominator == 1 else float(x)


def probe_cell(arch, shape_name, save=True, device=None, cfg=None):
    """The cell's flops, bytes and collectives extrapolated from counts at
    ``depth_pair``'s two depths (``cfg``: in place of ``arch``'s
    published config)."""
    cfg = cfg or get_config(arch)
    d1, d2, n_units = depth_pair(cfg)
    c1 = _cost_at_depth(arch, shape_name, d1, device, cfg)
    c2 = _cost_at_depth(arch, shape_name, d2, device, cfg)
    out = {"arch": arch, "shape": shape_name, "n_chips": 1,
           "depths": [d1, d2], "n_units": n_units}
    n_layers_eff = Fraction(n_units) * d1
    for k in ("flops", "bytes", "coll"):
        # the counts grow with depth, so the reference's clamps never bind
        per_layer = max(Fraction(c2[k] - c1[k], d2 - d1), Fraction(0))
        fixed = max(c1[k] - per_layer * d1, Fraction(0))
        out[k] = _exact(max(fixed + per_layer * n_layers_eff, c2[k]))
        out[f"{k}_fixed"] = _exact(fixed)
        out[f"{k}_per_layer"] = _exact(per_layer)
    out["coll_by_kind"] = {}
    print(f"[probe] {arch} x {shape_name}: flops/chip {out['flops']:.3e}, "
          f"bytes/chip {out['bytes']:.3e}, coll/chip 0.0MB")
    if save:
        PROBE_DIR.mkdir(parents=True, exist_ok=True)
        with open(PROBE_DIR / f"{arch}__{shape_name}.json", "w") as f:
            json.dump(out, f, indent=1)
    return out


def sweep(only_failed=False):
    """Every cell of ``config.cells()`` probed in a subprocess of its own,
    one after another (a failure or a hang stays in its cell, each under
    the dry-run's ``CELL_TIMEOUT_S``); ``only_failed`` skips the cells
    that have a record. A failure leaves ``<cell>.FAILED`` beside the
    records. Returns the failed cells' tags."""
    PROBE_DIR.mkdir(parents=True, exist_ok=True)
    failures = []
    for arch, shape_name in cells():
        if only_failed and (PROBE_DIR / f"{arch}__{shape_name}.json").exists():
            continue
        tag, ok, line = _run_one("repro_torch.launch.probe", PROBE_DIR, arch,
                                 shape_name, stdout_tail=3000)
        if ok:
            print(line)
        else:
            failures.append(tag)
            print(f"[probe] FAIL {tag}")
    print(f"[probe] sweep done; {len(failures)} failures: {failures}")
    return failures


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--only-failed", action="store_true")
    args = ap.parse_args(argv)
    if args.all:
        sys.exit(1 if sweep(args.only_failed) else 0)
    if not (args.arch and args.shape):
        ap.error("--arch and --shape are required without --all")
    try:
        probe_cell(args.arch, args.shape)
    except Exception:
        traceback.print_exc()
        sys.exit(1)


if __name__ == "__main__":
    main()
