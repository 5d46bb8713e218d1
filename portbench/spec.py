"""The benchmark's data, found by name.

``BENCHMARK.json`` at the root of the checkout names every cell; a cell
names its configuration (``configs/<config>.json``) and its traffic mix
(``traffic/<traffic>.json``), a configuration's ``model_type`` names its
architecture (``arch/<model_type>.py``), and every metric is a reader in
``metrics/<metric>.py``. Adding a cell, a mix, a configuration, an
architecture or a metric adds files and entries; no file here changes.
"""
from __future__ import annotations

import importlib.util
import json
import re
import sys
from dataclasses import dataclass
from pathlib import Path

HERE = Path(__file__).resolve().parent
# a published model_type, and so the stem of a file name
MODEL_TYPE = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_\-]{0,63}")


@dataclass
class Cell:
    name: str
    config_name: str
    chips: int
    config: dict          # the configuration file as it is run
    traffic: dict         # the traffic mix's parameters
    end_to_end: list      # the BENCHMARK.json entries this cell reports
    per_layer: list


def _reported(entries, cell_name):
    """The metric entries that ``cell_name`` reports: those without a
    ``workloads`` key, and those that list it."""
    return [m for m in entries
            if "workloads" not in m or cell_name in m["workloads"]]


def load_cell(root: Path, workload: str, bench_dir: Path = HERE) -> Cell:
    """The cell ``workload`` of ``root/BENCHMARK.json``, with its files
    read from ``bench_dir``."""
    spec = json.loads((Path(root) / "BENCHMARK.json").read_text())
    found = [w for w in spec["workloads"] if w["name"] == workload]
    if not found:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json; "
                       f"known: {[w['name'] for w in spec['workloads']]}")
    w = found[0]
    cfg_entry = [c for c in spec["configs"] if c["name"] == w["config"]][0]
    config = json.loads((Path(root) / cfg_entry["file"]).read_text())
    traffic = json.loads(
        (Path(bench_dir) / "traffic" / f"{w['traffic']}.json").read_text())
    return Cell(name=w["name"], config_name=w["config"],
                chips=int(w["chips"]),
                config=config, traffic=traffic,
                end_to_end=_reported(spec["end_to_end"], w["name"]),
                per_layer=_reported(spec["per_layer"], w["name"]))


def _load(name: str, path: Path):
    """The module of the file ``path``, loaded under ``name`` (and entered
    in ``sys.modules``, where a dataclass looks its module up)."""
    spec = importlib.util.spec_from_file_location(
        name.replace(".", "_").replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = module
    spec.loader.exec_module(module)
    return module


def metric_reader(name: str, bench_dir: Path = HERE):
    """``read(run)`` of ``metrics/<name>.py``: the metric's value from a
    run's records, or ``None`` where the run holds nothing to read."""
    return _load(f"portbench_metric_{name}",
                 Path(bench_dir) / "metrics" / f"{name}.py").read


def architecture(config: dict, bench_dir: Path = HERE):
    """The module ``arch/<model_type>.py`` of the configuration file
    ``config``. It gives ``shapes(cfg, name)`` (the sizes; the harness
    reads ``name``, ``n_layers``, ``vocab``, ``dtype`` and ``moe``),
    ``port_config(cfg, s)`` (the port's ``ModelConfig``), ``leaves(s)``
    (the weights' ``(path, shape, dtype, std)`` in drawing order),
    ``Reference`` (the plain float32 reference, ``Reference(s, host,
    device, weights="f32" | "fp8")``) and ``prompt_flops(s, T)``,
    ``token_flops(s, visible)`` and ``head_flops(s)`` (the analytic step
    operations)."""
    model_type = config.get("model_type")
    path = Path(bench_dir) / "arch" / f"{model_type}.py"
    if not isinstance(model_type, str) or \
            not MODEL_TYPE.fullmatch(model_type) or not path.is_file():
        raise ValueError(
            f"no architecture for model_type {model_type!r}: add "
            f"{Path(bench_dir).name}/arch/{model_type}.py with shapes, "
            "port_config, leaves, Reference and the step operations "
            "(README.md, Adding a configuration)")
    return _load(f"portbench_arch_{model_type}", path)
