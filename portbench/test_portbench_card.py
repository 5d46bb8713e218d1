"""On the card: the controls of the dense cell's check at a size a test
run holds (qwen3-14b at its published widths, 2 of 40 layers, the
npc4.vram50 mix for a short window). The program comes out correct; the
reference computed in fp8 exceeds the configuration's widest-gap limit
on the program's sample; the program served through its own int8 FFN
path comes out not correct. Skips where there is no card; run it there
with ``python -m pytest portbench/test_portbench_card.py``."""
import json
import shutil

import pytest

from portbench.harness import run_cell
from portbench.spec import HERE


@pytest.mark.card
def test_control_fails_and_program_passes(card, tmp_path):
    bench = tmp_path / "bench"
    for sub in ("arch", "traffic", "metrics"):
        shutil.copytree(HERE / sub, bench / sub)
    (bench / "configs").mkdir()
    cfg = json.loads((HERE / "configs" / "qwen3-14b-10of40.json")
                     .read_text())
    cfg["num_hidden_layers"] = 2
    (bench / "configs" / "q.json").write_text(json.dumps(cfg))
    real = json.loads((HERE.parent / "BENCHMARK.json").read_text())
    (tmp_path / "BENCHMARK.json").write_text(json.dumps({
        "configs": [{"name": "q", "file": "bench/configs/q.json"}],
        "workloads": [{"name": "q.npc4", "config": "q",
                       "traffic": "npc4.vram50", "chips": 1}],
        "end_to_end": real["end_to_end"], "per_layer": []}))
    for seed in (2 ** 31 + 1, 2 ** 31 + 2):
        result, checks = run_cell(tmp_path, "q.npc4", seed, 6.0,
                                  device=card, bench_dir=bench,
                                  fp8_control=True, log=lambda *a: None)
        c = {name: (value, limit) for name, value, limit, _ in checks}
        gap, limit = c["max_logit_gap"]
        assert gap <= limit < c["control_max_logit_gap"][0], c
        assert c["off_dtype_weight_bytes"][0] == 0
        assert result["correct"]
        result, checks = run_cell(tmp_path, "q.npc4", seed, 6.0,
                                  device=card, bench_dir=bench,
                                  weight_quant="int8", log=lambda *a: None)
        c = {name: (value, limit) for name, value, limit, _ in checks}
        assert c["off_dtype_weight_bytes"][0] > 0, c
        assert not result["correct"]
