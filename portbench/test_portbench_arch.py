"""A configuration's architecture is found by its ``model_type``
(``arch/<model_type>.py``), and Qwen3's file gives every reading a cell
takes as the harness took it before the architecture had a file of its
own: the port's ``ModelConfig`` and the analytic step operations at
published widths, and the drawn weights and the reference's logits at
smoke size, bit for bit. The pinned values were read from the harness
at ``986728e``."""
import hashlib
import json
import shutil

import numpy as np
import pytest
import torch

from portbench import harness, spec
from portbench.conftest import TINY_DENSE, TINY_MOE
from portbench.harness import run_cell
from portbench.spec import HERE
from portbench.weights import draw_weights

CONFIGS = {n: json.loads((HERE / "configs" / f"{n}.json").read_text())
           for n in ("qwen3-14b-10of40", "qwen3-30b-a3b-12of48")}
CONFIGS.update({"tiny-dense": TINY_DENSE, "tiny-moe": TINY_MOE})
TINY = ("tiny-dense", "tiny-moe")

# ModelConfig's arguments; every other field keeps its default
PORT_CONFIG = {
    "qwen3-14b-10of40": dict(
        family="dense", n_layers=10, d_model=5120, n_heads=40, n_kv_heads=8,
        d_ff=17408, vocab=151936, head_dim=128, qk_norm=True,
        source="https://huggingface.co/Qwen/Qwen3-14B/blob/main/config.json"),
    "qwen3-30b-a3b-12of48": dict(
        family="moe", n_layers=12, d_model=2048, n_heads=32, n_kv_heads=4,
        d_ff=768, vocab=151936, head_dim=128, qk_norm=True,
        moe=dict(n_experts=128, top_k=8, d_expert=768, capacity_factor=16.0,
                 router_dtype="float32"),
        source="https://huggingface.co/Qwen/Qwen3-30B-A3B/blob/main/"
               "config.json"),
    "tiny-dense": dict(
        family="dense", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=128, vocab=512, head_dim=16, qk_norm=True),
    "tiny-moe": dict(
        family="moe", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=32, vocab=512, head_dim=16, qk_norm=True,
        moe=dict(n_experts=8, top_k=2, d_expert=32, capacity_factor=4.0,
                 router_dtype="float32"), dtype="float32"),
}

# prompt_flops at T, token_flops at visible, head_flops
STEP_FLOPS = {
    "qwen3-14b-10of40": (
        {1: 8162058240, 256: 1699436298240, 1024: 6873608355840},
        {1: 6606233600, 300: 6667468800, 1088: 6828851200}, 1555824640),
    "qwen3-30b-a3b-12of48": (
        {1: 1987772416, 256: 356592910336, 1024: 1501814063104},
        {1: 1365442560, 300: 1424228352, 1088: 1579155456}, 622329856),
    "tiny-dense": (
        {1: 213504, 256: 54657024, 1024: 419758080},
        {1: 147968, 300: 301056, 1088: 704512}, 65536),
    "tiny-moe": (
        {1: 166400, 256: 42598400, 1024: 371523584},
        {1: 100864, 300: 253952, 1088: 657408}, 65536),
}

WEIGHT_SEED = 2 ** 33 + 5
# SHA-256 of each leaf's bytes, drawn on the CPU from WEIGHT_SEED
LEAF_SHA256 = {
    "tiny-dense": {
        "embed": "37f52b88cbc83ecce85f5fcb519cea3cccbe65c9976a385e98e0e2fdf6ce3e5d",
        "final_norm": "4624c3718eff22331243cb9b711755801058ebc026cb5c3d37b36ceb9fda0454",
        "layers/ln1": "2e9a9fd210b9f5198e048e3cd0a86e8aaf3fef9dce8de163eb78c5191635ac22",
        "layers/ln2": "18b05cbe7f06fd84e32a54c077c179587f193bbd4118879db3978126bc101529",
        "layers/attn/wq": "7c1691f0854750e85acd92e46a5504058341819e13db9b26854892639aefd567",
        "layers/attn/wk": "61cd6ff8997392ad9e6d83ff50d361a9240c3ddbda0fe96abf13df4a069a1d83",
        "layers/attn/wv": "ba8c2594f88c8b94210ef467f639ac5b1922fa957279fa411933737e53f5371b",
        "layers/attn/wo": "2a8dd1ccfb60aae6d422a41e0a5cc20d0a9c50eee510556c638d95638d2d37c9",
        "layers/attn/q_norm": "a29825ea565855bf1be104e033990de6199b35345b17c765ba7919153ff34c11",
        "layers/attn/k_norm": "de084d766acb10c8e4ebbac15e13973a8da76ed89722ac1cf41a288410f5f476",
        "layers/ffn/w_gate": "d9420404babbb94411995cb300965191dadbadbc31d19b7d1a701c5b4ded4a55",
        "layers/ffn/w_up": "fe421a1e6b61e916498beefa3871d6da7a76bb10ca06dcf4769faecaeb0bd239",
        "layers/ffn/w_down": "cfcf8a77073888f0570eaa2812c7f1f067df598cd2c6699dc3da540229e0a800",
        "unembed": "046595728528a0bb56d56e7232a42ad6459c24da92fdef2c61d334abfe12f67e",
    },
    "tiny-moe": {
        "embed": "d694e1649f00fda8807f248701e879cb789bb5eead4dc21678caf2acc07d9b74",
        "final_norm": "a8cf2b815a581148e075a2267a16af20b5a7fa894c61586d051479f6ccdce68a",
        "layers/ln1": "e541ff618c8549a56471a04bccf9429fb8caf991204e82a1b97ef4aa4b52e07a",
        "layers/ln2": "e587e94f78014c7bc50c36bd377b0743cbc5725a5f73e28794317e2129d2a391",
        "layers/attn/wq": "26fc3c88257fb68190d9aed7ca3f7f4815276b4bb8be3e714465ad2b560fecd6",
        "layers/attn/wk": "de0eabed0a28390aed9bb0d0ee2070a1825ce5e93e181a8fad47ffbf03da6477",
        "layers/attn/wv": "1f83fbde7444f5ae8015cb9479ec286f9024b2f3d12cda9a3c5bac4bbd0caada",
        "layers/attn/wo": "f82916aca9eb27553939f218b401994093509caca141dcba44b5ce509efd2203",
        "layers/attn/q_norm": "7697be6ef5b5b2768631a8ffd977728d0928b1e4f89a523e6f7b76f4c89308f7",
        "layers/attn/k_norm": "2cfd7579c2550a195175f604ab8666218eb7cf0c83b0ce495d28f3920673cdb5",
        "layers/moe/router": "4bb5b37bbff09c4eeb4ffa9c2c238bc2fcb6280d08bd597a1297fa3346596625",
        "layers/moe/w_gate": "9852be54122b5d39448f29f0aba299f772a897b88fb226c3d3c9691904c5e2e6",
        "layers/moe/w_up": "98d6c1da5ce70771255f1f2df7386230b0cf659c6e9ee8ceaec44e35fd92cdc1",
        "layers/moe/w_down": "4424918891924f9c8b54be63c232f9b70a50e6cafd89adcf375f1f85dd93dec5",
        "unembed": "c196dd32b389bfcd5d4dada74b0c41eadd3eafb771f5ce7fc9f27f4cac86068d",
    },
}
# SHA-256 of the reference's f32 logits at every position of two fixed
# 37-token sequences, over the weights above, on one CPU thread
LOGITS_SHA256 = {
    "tiny-dense": "e2663c540720cbe36a61816b0cd0e1f2d2aaadcaaa68b561661e794ec219e7cb",
    "tiny-moe": "a403410f0d1f17ccfcf4120938acc7472310106c99141632487c8d1260fb2cbe",
}


def _sha256(t: torch.Tensor) -> str:
    return hashlib.sha256(t.contiguous().reshape(-1).view(torch.uint8)
                          .numpy().tobytes()).hexdigest()


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), v


def _tiny_weights(name):
    arch = spec.architecture(CONFIGS[name])
    s = arch.shapes(CONFIGS[name], name)
    return arch, s, draw_weights(arch.leaves(s), WEIGHT_SEED, "cpu")


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_port_config_is_unchanged(name):
    from repro_torch.config import ModelConfig, MoEConfig
    cfg = CONFIGS[name]
    arch = spec.architecture(cfg)
    kw = dict(PORT_CONFIG[name])
    if "moe" in kw:
        kw["moe"] = MoEConfig(**kw["moe"])
    want = ModelConfig(name=name, mlp="swiglu", pos="rope",
                       rope_theta=1e6, norm_eps=1e-6, **kw)
    assert arch.port_config(cfg, arch.shapes(cfg, name)) == want


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_step_operations_are_unchanged(name):
    arch = spec.architecture(CONFIGS[name])
    s = arch.shapes(CONFIGS[name], name)
    prompt, token, head = STEP_FLOPS[name]
    assert {T: arch.prompt_flops(s, T) for T in prompt} == prompt
    assert {v: arch.token_flops(s, v) for v in token} == token
    assert arch.head_flops(s) == head


@pytest.mark.parametrize("name", TINY)
def test_weights_are_unchanged_bit_for_bit(name):
    _, _, host = _tiny_weights(name)
    got = {path: _sha256(t) for path, t in _flat(host)}
    assert list(got) == list(LEAF_SHA256[name])
    assert got == LEAF_SHA256[name]


@pytest.mark.parametrize("name", TINY)
def test_reference_logits_are_unchanged_bit_for_bit(name):
    arch, s, host = _tiny_weights(name)
    toks = np.random.default_rng(0).integers(0, s.vocab, size=(2, 37))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        z = arch.Reference(s, host, "cpu").logits(
            [toks[0], toks[1]], [np.arange(37)] * 2)
    finally:
        torch.set_num_threads(threads)
    assert _sha256(torch.cat(z)) == LOGITS_SHA256[name]


@pytest.mark.parametrize("model_type", ["qwen3", "qwen3_moe"])
def test_both_qwen3_types_resolve_by_name(model_type):
    arch = spec.architecture({"model_type": model_type})
    for name in ("shapes", "port_config", "leaves", "Reference",
                 "prompt_flops", "token_flops", "head_flops"):
        assert callable(getattr(arch, name)), name
    # the configuration checks came along: a GELU decoder is refused
    with pytest.raises(ValueError, match="SwiGLU"):
        arch.shapes(dict(TINY_DENSE, hidden_act="gelu"))


def _add_cell(root, bench, name, cfg):
    (bench / "configs" / f"{name}.json").write_text(json.dumps(cfg))
    b = json.loads((root / "BENCHMARK.json").read_text())
    b["configs"].append({"name": name, "file": f"bench/configs/{name}.json"})
    b["workloads"].append({"name": f"{name}.tiny", "config": name,
                           "traffic": "tiny", "chips": 1})
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    return f"{name}.tiny"


def test_a_new_model_type_runs_with_new_files_only(tiny_bench):
    """A copy of the Qwen3 file under a made-up ``model_type``, and a
    configuration that names it: a run on the CPU finds it by name and
    comes out correct."""
    root, bench = tiny_bench
    shutil.copy(bench / "arch" / "qwen3.py", bench / "arch" / "made_up_lm.py")
    cfg = dict(TINY_DENSE, model_type="made_up_lm")
    assert spec.architecture(cfg, bench).__file__ == \
        str(bench / "arch" / "made_up_lm.py")
    cell = _add_cell(root, bench, "tiny-made-up", cfg)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        result, checks = run_cell(root, cell, 2 ** 32 + 3, 3.0, device="cpu",
                                  bench_dir=bench, log=lambda *a: None)
    finally:
        torch.set_num_threads(threads)
    checks = {c[0]: c for c in checks}
    assert result["correct"], checks
    assert checks["compared_tokens"][1] > 0


@pytest.mark.parametrize("model_type", ["no_such_lm", "../arch/qwen3", None])
def test_unknown_model_type_fails_before_weights(tiny_bench, monkeypatch,
                                                  model_type):
    root, bench = tiny_bench
    drawn = []
    monkeypatch.setattr(harness, "draw_weights",
                        lambda *a, **kw: drawn.append(a))
    cfg = dict(TINY_DENSE, model_type=model_type)
    cell = _add_cell(root, bench, "tiny-unknown", cfg)
    with pytest.raises(ValueError) as e:
        run_cell(root, cell, 7, 1.0, device="cpu", bench_dir=bench,
                 log=lambda *a: None)
    assert f"add bench/arch/{model_type}.py" in str(e.value)
    assert not drawn
    with pytest.raises(ValueError, match=f"add portbench/arch/{model_type}.py"):
        spec.architecture(cfg)
