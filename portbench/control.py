"""The control of a cell's check, on the card: for each seed, one short
run of the cell (set-up, warm-up, a window at the cell's own load) and
the gaps of its served tokens against the reference, and, as the
controls, the same cell served through the port's own int8 FFN path
(``weight_quant="int8"``, K2) and the reference computed in fp8 on the
program's sample.

    python3 portbench/control.py --workload <cell> --seeds 1,2,3 \
        --seconds 20 [--controls int8,fp8]

Prints one JSON line per seed and side with the gaps' statistics. The
limit of a cell's number lies between the program's highest reading
over a dozen seeds or more and the controls' lowest (PERF.md).
"""
import sys
import time

from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[0] = str(ROOT)
sys.path.insert(1, str(ROOT / "src"))


def main(argv=None):
    import argparse
    import gc
    import json
    import torch
    from portbench.harness import run_cell
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=20.0)
    p.add_argument("--controls", default="int8,fp8",
                   help="any of int8 (the port's int8 FFN path) and fp8 "
                        "(the reference in fp8); empty: the program only")
    a = p.parse_args(argv)
    controls = [c for c in a.controls.split(",") if c]
    sides = [("program", "fp16")] + [("int8", "int8")] * ("int8" in controls)
    for seed in (int(x) for x in a.seeds.split(",")):
        for side, quant in sides:
            t0 = time.time()
            gaps = {}

            def log(*m):
                line = " ".join(str(x) for x in m)
                for tag in ("program gaps ", "control gaps "):
                    if line.startswith(tag):
                        gaps[tag.split()[0]] = json.loads(line[len(tag):])
                print(line, flush=True)
            result, checks = run_cell(
                ROOT, a.workload, seed, a.seconds, t_process=t0, log=log,
                fp8_control=side == "program" and "fp8" in controls,
                weight_quant=quant)
            print(json.dumps({"workload": a.workload, "seed": seed,
                              "side": side, "gaps": gaps.get("program"),
                              "fp8_gaps": gaps.get("control"),
                              "checks": {c[0]: c[1] for c in checks},
                              "correct": result["correct"],
                              "seconds": round(time.time() - t0, 1)}),
                  flush=True)
            gc.collect()
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
