"""Nemotron-H in the benchmark: a tiny model of its architecture through
``run_cell`` on the CPU comes out correct; the architecture file's
readings at the published widths are pinned (the port's configuration,
the leaves, the graph and its state, the frozen step operations); the
frozen counts agree with the plain reference's own products at the tiny
size; the scan's two drawn laws; the reference imports nothing of the
program; and the three Mamba-2 readers on hand-built spans."""
import ast
import json
import math
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from portbench import spec
from portbench.harness import Step, run_cell
from portbench.spec import HERE
from portbench.weights import draw_weights

# the CPU tests' model: every mixer kind, two groups of B and C, a conv
# bias; widths 64 / 128 (Mamba-2 heads 8 of 16, state 16)
TINY_NEMOTRON_H = {
    "model_type": "nemotron_h", "hybrid_override_pattern": "M-M*-M-",
    "num_hidden_layers": 7, "hidden_size": 64, "intermediate_size": 128,
    "num_attention_heads": 4, "num_key_value_heads": 2,
    "attention_head_dim": 16, "mamba_num_heads": 8, "mamba_head_dim": 16,
    "expand": 2, "n_groups": 2, "ssm_state_size": 16, "conv_kernel": 4,
    "use_conv_bias": True, "chunk_size": 8, "time_step_min": 0.001,
    "time_step_max": 0.1, "time_step_floor": 1e-4,
    "time_step_limit": [0, None], "layer_norm_epsilon": 1e-5,
    "mlp_hidden_act": "relu2", "mamba_hidden_act": "silu",
    "vocab_size": 512, "tie_word_embeddings": False,
    "torch_dtype": "bfloat16",
    "check": {"max_logit_gap": 0.25, "sample_requests": 16},
}
NAME = "nemotron-h-47b-19of98"
CONFIG = json.loads((HERE / "configs" / f"{NAME}.json").read_text())
CELL = "nemotron-h-47b.npc4.vram50"


def _arch(cfg, name):
    arch = spec.architecture(cfg)
    return arch, arch.shapes(cfg, name)


def test_tiny_model_runs_correct_through_the_harness(tiny_bench):
    root, bench = tiny_bench
    (bench / "configs" / "tiny-nh.json").write_text(
        json.dumps(TINY_NEMOTRON_H))
    b = json.loads((root / "BENCHMARK.json").read_text())
    b["configs"].append({"name": "tiny-nh",
                         "file": "bench/configs/tiny-nh.json"})
    b["workloads"].append({"name": "tiny-nh.tiny", "config": "tiny-nh",
                           "traffic": "tiny", "chips": 1})
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        result, checks = run_cell(root, "tiny-nh.tiny", 2 ** 32 + 3, 3.0,
                                  device="cpu", bench_dir=bench,
                                  log=lambda *a: None)
    finally:
        torch.set_num_threads(threads)
    checks = {c[0]: c for c in checks}
    assert result["correct"], checks
    assert checks["compared_tokens"][1] > 0
    assert checks["off_dtype_weight_bytes"][1] == 0
    assert result["failed"] == 0


def test_cell_and_metrics_are_declared():
    b = json.loads((HERE.parent / "BENCHMARK.json").read_text())
    cell = [w for w in b["workloads"] if w["name"] == CELL][0]
    assert (cell["config"], cell["traffic"], cell["chips"]) == \
        (NAME, "npc4.vram50", 1)
    news = {m["name"]: m for m in b["per_layer"]
            if m["name"] in ("mamba_decode_ms", "mamba_prefill_ms_per_ktok",
                             "hybrid_step_mfu")}
    assert {n: m["workloads"] for n, m in news.items()} == \
        {n: [CELL] for n in news} and len(news) == 3
    loaded = spec.load_cell(HERE.parent, CELL)
    assert {m["name"] for m in loaded.end_to_end} == \
        {"itl_p95_ms", "out_tok_s", "setup_s"}
    assert [m["name"] for m in loaded.per_layer] == list(news)


def test_port_config_at_published_widths():
    from repro_torch.config import ModelConfig
    arch, s = _arch(CONFIG, NAME)
    assert arch.port_config(CONFIG, s) == ModelConfig(
        name=NAME, family="hybrid", n_layers=19, d_model=8192, n_heads=64,
        n_kv_heads=8, d_ff=30720, vocab=131072, head_dim=128, mlp="relu2",
        pos="none", ssm_state=256, ssm_head_dim=64, ssm_expand=2,
        ssm_conv=4, ssm_groups=8, ssm_conv_bias=True,
        layer_pattern="M-M-M-M-M-M-M-M-M*-", norm_eps=1e-5,
        source="https://huggingface.co/nvidia/Nemotron-H-47B-Base-8K/blob/"
               "main/config.json")


def test_leaves_at_published_widths():
    arch, s = _arch(CONFIG, NAME)
    bf, f32 = torch.bfloat16, torch.float32
    got = [("/".join(p), tuple(sh), dt) for p, sh, dt, _ in arch.leaves(s)]
    assert got == [
        ("embed", (131072, 8192), bf), ("final_norm", (8192,), bf),
        ("layers/ln", (19, 8192), bf),
        ("layers/mamba/w_in", (9, 8192, 37120), bf),
        ("layers/mamba/conv_w", (9, 4, 20480), bf),
        ("layers/mamba/conv_b", (9, 20480), bf),
        ("layers/mamba/a_log", (9, 256), f32),
        ("layers/mamba/dt_bias", (9, 256), f32),
        ("layers/mamba/d_skip", (9, 256), f32),
        ("layers/mamba/gate_norm", (9, 16384), bf),
        ("layers/mamba/w_out", (9, 16384, 8192), bf),
        ("layers/ffn/w_up", (9, 8192, 30720), bf),
        ("layers/ffn/w_down", (9, 30720, 8192), bf),
        ("layers/attn/wq", (1, 8192, 8192), bf),
        ("layers/attn/wk", (1, 8192, 1024), bf),
        ("layers/attn/wv", (1, 8192, 1024), bf),
        ("layers/attn/wo", (1, 8192, 8192), bf),
        ("unembed", (8192, 131072), bf)]
    drawn = sum(math.prod(sh) * (4 if dt == f32 else 2)
                for _, sh, dt in got)
    assert drawn == 21548633088


def test_graph_and_state_at_published_widths():
    from repro_torch.core import (InferenceSetting, build_graph,
                                  total_weight_bytes)
    arch, s = _arch(CONFIG, NAME)
    cfg = arch.port_config(CONFIG, s)
    g = build_graph(cfg)
    assert total_weight_bytes(g) == 21546139648
    by_kind = {}
    for sub in g:
        by_kind.setdefault(sub.kind, set()).add(sub.weight_bytes)
    assert by_kind == {"embed": {2147483648}, "out": {2147483648},
                       "mamba": {876609536}, "ffn": {1006632960},
                       "attn": {301989888}, "kv": {0}, "state": {0}}
    assert [sub.name for sub in g if sub.layer == 17] == \
        ["L17/attn", "L17/kv"]
    at = InferenceSetting(batch=4, context=1088)
    # 9 layers x 4 slots x (256 x 64 x 256 f32 + 3 x 20480 bf16)
    assert sum(sub.bytes_resident(at) for sub in g
               if sub.kind == "state") == 608403456
    assert sum(sub.bytes_resident(at) for sub in g
               if sub.kind == "kv") == 17825792
    assert cfg.param_count() == 10774159872


# prompt_flops at T, token_flops at visible, head_flops
STEP_FLOPS = (
    {1: 19628019712, 256: 4464451256320, 1024: 17864247476224},
    {1: 17442455552, 300: 17452253184, 1088: 17478074368}, 2147483648)


def test_step_operations_are_pinned():
    arch, s = _arch(CONFIG, NAME)
    prompt, token, head = STEP_FLOPS
    assert {T: arch.prompt_flops(s, T) for T in prompt} == prompt
    assert {v: arch.token_flops(s, v) for v in token} == token
    assert arch.head_flops(s) == head


@pytest.mark.parametrize("T", [1, 9, 20])
def test_counts_match_the_references_products(T):
    """The reference's products (``FlopCounterMode``: its matrix
    products, attention over the whole T x T square, masked, and the
    scan's read-out ``C h`` at each step) on one sequence of T tokens,
    every position scored, against the frozen count's product terms."""
    from torch.utils.flop_counter import FlopCounterMode

    from portbench.roofline import nemotron_h as work
    cfg = dict(TINY_NEMOTRON_H, torch_dtype="float32")
    arch, s = _arch(cfg, "tiny")
    host = draw_weights(arch.leaves(s), 3, "cpu")
    toks = np.random.default_rng(0).integers(0, s.vocab, size=T)
    with FlopCounterMode(display=False) as fc:
        arch.Reference(s, host, "cpu").logits([toks], [np.arange(T)])
    per = {"M": work.mamba_proj(s) + work.ssd_readout(s), "-": work.mlp(s),
           "*": work.attn_proj(s) + work.attn_scores(s, T)}
    assert fc.get_total_flops() == \
        T * (sum(per[k] for k in s.pattern) + work.head_flops(s))


def test_one_token_prompt_is_a_decoded_token_but_for_the_scan():
    """A one-token prompt is a decoded token seeing itself, its logits
    row, and in each of the 9 Mamba-2 layers the chunked scan of one
    token in place of the recurrence step: the pair's C B product per
    group and its sum of x per head (2 (g N + h P)), the state and its
    read-out (4 h P N) and the carry (2 h P N), against the step's 5 h P
    N."""
    arch, s = _arch(CONFIG, NAME)
    assert arch.prompt_flops(s, 1) - arch.token_flops(s, 1) \
        - arch.head_flops(s) == 9 * (2 * (8 * 256 + 256 * 64)
                                     + 256 * 64 * 256)


def test_the_scan_parameters_follow_their_laws():
    cfg = dict(TINY_NEMOTRON_H, mamba_num_heads=2048, mamba_head_dim=1,
               hidden_size=1024)
    arch, s = _arch(cfg, "laws")
    a = draw_weights(arch.leaves(s), 11, "cpu")["layers"]["mamba"]
    A = torch.exp(a["a_log"])
    assert float(A.min()) >= 1 and float(A.max()) <= 16
    # uniform on [1, 16]: mean 8.5, sd 4.33 over 3 x 2048 draws
    assert abs(float(A.mean()) - 8.5) < 0.3
    dt = torch.nn.functional.softplus(a["dt_bias"])
    assert float(dt.min()) >= 1e-4 * (1 - 1e-5)
    assert float(dt.max()) <= 0.1 * (1 + 1e-5)
    # log-uniform on [1e-3, 1e-1]: log10 dt has mean -2
    assert abs(float(torch.log10(dt).mean()) + 2) < 0.05
    again = draw_weights(arch.leaves(s), 11, "cpu")["layers"]["mamba"]
    assert torch.equal(again["a_log"], a["a_log"])
    assert torch.equal(again["dt_bias"], a["dt_bias"])


def test_reference_imports_nothing_of_the_program():
    tree = ast.parse((HERE / "reference" / "nemotron_h.py").read_text())
    mods = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            mods.add(node.module.split(".")[0])
    assert mods == {"__future__", "contextlib", "torch"}


# ------------------------------------------------------------ readers
def _span(id, name, t0, t1, parent=None, **attrs):
    from repro_torch.core import trace
    s = trace.Span(id, name, t0, parent, 1, None)
    s.t1_ns = t1
    s.attrs = attrs
    return s


def _spans():
    # two decode passes (mamba 3,000 + 1,000 ns, and 2,000), two
    # admissions of 300 and 200 prompt tokens (mamba 4,000 ns, nested
    # under a wait-free sub-span, and 1,000), and a pass after the window
    return [
        _span(1, "serve.decode", 1000, 11000),
        _span(2, "sub.mamba", 1100, 4100, 1, layer=0, source="pinned"),
        _span(3, "sub.ffn", 4100, 6000, 1),
        _span(4, "sub.mamba", 6000, 7000, 1, layer=2, source="streamed"),
        _span(5, "serve.decode", 20000, 26000),
        _span(6, "sub.mamba", 20100, 22100, 5),
        _span(7, "serve.admit", 30000, 40000, prompt_tokens=300),
        _span(8, "sub.mamba", 30100, 34100, 7),
        _span(9, "wait.weights", 30200, 30300, 8),
        _span(10, "serve.admit", 41000, 45000, prompt_tokens=200),
        _span(11, "sub.mamba", 41100, 42100, 10),
        _span(12, "serve.decode", 100000, 200000),
        _span(13, "sub.mamba", 100100, 199000, 12),
    ]


RUN = SimpleNamespace(w0_ns=0, last_ns=50000)


@pytest.mark.parametrize("name,want", [
    ("mamba_decode_ms", 3000e-6),          # 6,000 ns over 2 passes
    ("mamba_prefill_ms_per_ktok", 0.01),   # 5,000 ns over 0.5 ktok
])
def test_mamba_readers_sum_their_spans(name, want, monkeypatch):
    from repro_torch.core import trace
    monkeypatch.setattr(trace, "spans", _spans)
    assert spec.metric_reader(name)(RUN) == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("name", ["mamba_decode_ms",
                                  "mamba_prefill_ms_per_ktok"])
def test_mamba_readers_none_without_mamba_spans(name, monkeypatch):
    """A decoder's run (no ``sub.mamba``), an empty window, and a run
    with no spans read None."""
    from repro_torch.core import trace
    plain = [s for s in _spans() if s.name != "sub.mamba"]
    monkeypatch.setattr(trace, "spans", lambda: plain)
    assert spec.metric_reader(name)(RUN) is None
    monkeypatch.setattr(trace, "spans", _spans)
    assert spec.metric_reader(name)(
        SimpleNamespace(w0_ns=300000, last_ns=400000)) is None
    monkeypatch.setattr(trace, "spans", lambda: [])
    assert spec.metric_reader(name)(RUN) is None


def test_hybrid_step_mfu_reads_the_steps_operations():
    steps = [Step(0, 10, 0, 0, 4, 10 ** 12), Step(10, 20, 1, 300, 1,
                                                  3 * 10 ** 12)]
    run = SimpleNamespace(steps=steps, w0_ns=0, last_ns=2 * 10 ** 9)
    # 4e12 operations over 2 s at 989 TFLOP/s
    assert spec.metric_reader("hybrid_step_mfu")(run) == \
        pytest.approx(4e12 / (2 * 989e12) * 100, rel=1e-12)
