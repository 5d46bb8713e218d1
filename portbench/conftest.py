"""The benchmark's tests: a marker for the one that needs the card, and
a throwaway benchmark of tiny cells that runs on the CPU."""
import json
import shutil

import pytest

from portbench.spec import HERE

TINY_DENSE = {
    "model_type": "qwen3", "hidden_act": "silu", "attention_bias": False,
    "hidden_size": 64, "intermediate_size": 128, "num_attention_heads": 4,
    "num_key_value_heads": 2, "head_dim": 16, "num_hidden_layers": 2,
    "rms_norm_eps": 1e-6, "rope_theta": 1000000.0,
    "tie_word_embeddings": False, "vocab_size": 512,
    "torch_dtype": "bfloat16", "check": {"max_logit_gap": 0.25},
}
# in f32: at width 64 a bf16 rounding flips top-2-of-8 routes often, and
# one flip moves a logit by its own size; the served MoE cell compares the
# mean gap for that reason (PERF.md)
TINY_MOE = dict(TINY_DENSE, model_type="qwen3_moe", num_experts=8,
                num_experts_per_tok=2, moe_intermediate_size=32,
                norm_topk_prob=True, decoder_sparse_step=1,
                mlp_only_layers=[], torch_dtype="float32",
                check={"mean_logit_gap": 0.02})
TINY_MIX = {
    "loop": "closed", "clients": 3,
    "prompt_len": {"dist": "log_uniform", "min": 8, "max": 40},
    "output_len": {"dist": "uniform", "min": 3, "max": 8},
    "block": 8, "max_batch": 3, "max_seq": 64,
    "kv_layout": "stacked", "budget_fraction": 0.5,
    "warmup": {"prompt_len": [40, 8, 20], "output_len": 2},
}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips where there is none")


def _every_cell(metric):
    return {k: v for k, v in metric.items() if k != "workloads"}


def make_bench(root):
    """A benchmark root in ``root``: BENCHMARK.json with a tiny dense and
    a tiny MoE cell, their files, and the real architectures and metric
    readers."""
    bench = root / "bench"
    (bench / "configs").mkdir(parents=True)
    (bench / "traffic").mkdir()
    for sub in ("arch", "metrics"):
        shutil.copytree(HERE / sub, bench / sub)
    for name, cfg in (("tiny-dense", TINY_DENSE), ("tiny-moe", TINY_MOE)):
        (bench / "configs" / f"{name}.json").write_text(json.dumps(cfg))
    (bench / "traffic" / "tiny.json").write_text(json.dumps(TINY_MIX))
    real = json.loads((HERE.parent / "BENCHMARK.json").read_text())
    spec = {
        "configs": [{"name": n, "file": f"bench/configs/{n}.json"}
                    for n in ("tiny-dense", "tiny-moe")],
        "workloads": [{"name": f"{n}.tiny", "config": n, "traffic": "tiny",
                       "chips": 1} for n in ("tiny-dense", "tiny-moe")],
        "end_to_end": [_every_cell(m) for m in real["end_to_end"]],
        "per_layer": [_every_cell(m) for m in real["per_layer"]
                      if m["source"] != "device_trace"],
    }
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return bench


@pytest.fixture
def tiny_bench(tmp_path):
    return tmp_path, make_bench(tmp_path)


@pytest.fixture
def card():
    """The CUDA card, or a skip where there is none."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
