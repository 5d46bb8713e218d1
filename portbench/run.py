"""One run of one benchmark cell of the PyTorch/CUDA port.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout. Prints, as its last line of standard
output, one JSON object with the run's result; see README.md.
"""
import sys
import time

T_PROCESS = time.time()

from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# the checkout's root, not this folder, leads the import path: the
# harness is the package ``portbench``; the port is under ``src``
sys.path[0] = str(ROOT)
sys.path.insert(1, str(ROOT / "src"))
# the port builds its kernels with nvcc into build/kernels/ of the
# checkout (repro_torch/kernels/_build.py), so runs after the first
# reuse them

from portbench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t_process=T_PROCESS))
