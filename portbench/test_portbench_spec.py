"""Cells, configurations, mixes and metrics are found by name: a
throwaway set of them in a temporary directory runs with no edit to any
file of the benchmark."""
import json

from portbench import spec
from portbench.conftest import make_bench
from portbench.harness import run_cell

ROOT = spec.HERE.parent
NAME = r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$"


def test_throwaway_config_mix_and_metric_are_found(tmp_path):
    bench = make_bench(tmp_path)
    (bench / "metrics" / "prompt_tokens_sent.py").write_text(
        "def read(run):\n"
        "    return sum(len(r.prompt) for r in run.requests)\n")
    (bench / "metrics" / "nothing_to_read.py").write_text(
        "def read(run):\n    return None\n")
    mix = json.loads((bench / "traffic" / "tiny.json").read_text())
    mix["clients"] = 2
    (bench / "traffic" / "tiny.two.json").write_text(json.dumps(mix))
    b = json.loads((tmp_path / "BENCHMARK.json").read_text())
    b["workloads"].append({"name": "tiny-dense.two", "config": "tiny-dense",
                           "traffic": "tiny.two", "chips": 1})
    b["end_to_end"] += [
        {"name": "prompt_tokens_sent", "unit": "tokens", "better": "higher",
         "bound": 0.25, "source": "host_clock",
         "workloads": ["tiny-dense.two"]},
        {"name": "nothing_to_read", "unit": "s", "better": "lower",
         "bound": 0.25, "source": "host_clock"}]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    cell = spec.load_cell(tmp_path, "tiny-dense.two", bench)
    assert cell.traffic["clients"] == 2
    assert [m["name"] for m in cell.end_to_end][-2:] == \
        ["prompt_tokens_sent", "nothing_to_read"]
    assert "prompt_tokens_sent" not in [
        m["name"] for m in spec.load_cell(tmp_path, "tiny-dense.tiny",
                                          bench).end_to_end]
    result, _ = run_cell(tmp_path, "tiny-dense.two", 9, 1.0, device="cpu",
                         bench_dir=bench, log=lambda *a: None)
    m = result["metrics"]
    assert m["prompt_tokens_sent"]["value"] >= 2 * 8
    assert m["prompt_tokens_sent"]["unit"] == "tokens"
    assert "nothing_to_read" not in m
    assert {"ttft_p50_s", "itl_p95_ms", "out_tok_s", "setup_s"} <= set(m)


def test_benchmark_json_keeps_the_contract():
    import re
    b = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    names = [x["name"] for x in b["configs"] + b["workloads"]
             + b["end_to_end"] + b["per_layer"]]
    assert len(names) == len(set(names))
    assert all(re.match(NAME, n) for n in names)
    for c in b["configs"]:
        assert (ROOT / c["file"]).is_file()
        assert c["file"].startswith("portbench/")
    for w in b["workloads"]:
        assert (spec.HERE / "traffic" / f"{w['traffic']}.json").is_file()
        assert w["chips"] == 1 and len(w["why"]) <= 200
    ends = {m["name"] for m in b["end_to_end"]}
    assert "setup_s" in ends
    for m in b["end_to_end"] + b["per_layer"]:
        assert (spec.HERE / "metrics" / f"{m['name']}.py").is_file()
        assert re.match(r"^[A-Za-z0-9_/%.\-]{1,16}$", m["unit"])
    for m in b["per_layer"]:
        assert m["moves"] in ends
        assert set(m["workloads"]) <= {w["name"] for w in b["workloads"]}
