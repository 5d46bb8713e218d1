"""The serving examples' PyTorch twins against the reference examples, on
the CPU: ``examples/serve_vram_budget_torch.py``, ``quickstart_torch.py``
and ``serve_http_torch.py``.

Each test loads the reference example and its twin by file path and runs
both ``main``s in process, the twin with ``--device cpu``.

- f32, same weights: ``get_smoke_config`` is patched in both modules'
  namespaces to an f32 copy of the config, and a wrapper around
  ``Session.open`` in each namespace hands both the reference's drawn
  weights (bridged to the port by ``params_from_numpy``). Every printed
  line is then equal character for character once its wall-clock figures
  (and the port a socket bound) are masked: tier plans, est ms/iter, TTFT
  and TPS, streamed MB, engine counts, ``Schedule.diff`` summaries,
  sample tokens and SSE token ids.
- bf16 (the defaults): each twin's own identity flags read True.
- ``--full`` selects ``get_config(arch)``; without CUDA and without
  ``--device cpu`` every twin raises; no twin imports ``jax`` or
  ``repro``.
"""
import ast
import asyncio
import contextlib
import importlib.util
import io
import re
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.models import build_model as jax_build
from repro_torch.configs import get_smoke_config as torch_smoke
from repro_torch.models.api import params_from_numpy

torch.set_num_threads(1)

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"
TWINS = ("serve_vram_budget", "quickstart", "serve_http", "vlm_budget",
         "train_lm")
SERVING = TWINS[:3]
# wall-clock figures and the bound port: the only fields masked
MASKS = (re.compile(r"in +[0-9.]+ms"), re.compile(r"\(\+ *[0-9.]+ ms\)"),
         re.compile(r"ttft_p50=[0-9.]+ms"),
         re.compile(r"http://127\.0\.0\.1:[0-9]+"))


def load(name):
    """An example module loaded by its file path (``examples/`` is no
    package)."""
    spec = importlib.util.spec_from_file_location(
        f"example_{name}", EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def masked(text):
    out = []
    for line in text.splitlines():
        for m in MASKS:
            line = m.sub("<masked>", line)
        out.append(line)
    return out


def run_main(fn, *args):
    """(``fn(*args)``'s result, its printed lines with the wall-clock
    figures masked)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = fn(*args)
    return res, masked(buf.getvalue())


class WithParams:
    """Stands in for ``Session`` in an example's namespace: ``open`` hands
    ``params`` to every session of ``cfg`` (planning sessions of other
    configs draw nothing)."""

    def __init__(self, session_cls, cfg, params):
        self.session_cls, self.cfg, self.params = session_cls, cfg, params

    def open(self, cfg, *args, **kw):
        if cfg == self.cfg:
            kw["params"] = self.params
        return self.session_cls.open(cfg, *args, **kw)


def same_weights_f32(monkeypatch, ref, twin, arch):
    """Patch both modules to serve ``arch``'s smoke config in f32 with the
    reference's weights."""
    jcfg = jax_smoke(arch).replace(dtype="float32")
    tcfg = torch_smoke(arch).replace(dtype="float32")
    jp = jax_build(jcfg).init(jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp))
    monkeypatch.setattr(ref, "get_smoke_config", lambda a: jcfg)
    monkeypatch.setattr(twin, "get_smoke_config", lambda a: tcfg)
    monkeypatch.setattr(ref, "Session", WithParams(ref.Session, jcfg, jp))
    monkeypatch.setattr(twin, "Session", WithParams(twin.Session, tcfg, tp))


def in_order(lines):
    """The lines with ``[4]``'s re-budget answer moved to the end: it
    prints when its HTTP call returns, between the in-flight stream's
    tokens at a point that depends on timing alone."""
    rebudget = [line for line in lines
                if line.startswith("    rebudget applied:")]
    return [line for line in lines if line not in rebudget] + rebudget


def run_reference(monkeypatch, ref, argv):
    monkeypatch.setattr(sys, "argv", ["example"] + argv)
    if asyncio.iscoroutinefunction(ref.main):
        return run_main(lambda: asyncio.run(ref.main()))[1]
    return run_main(ref.main)[1]


# ------------------------------------------------- f32: the reference's lines
@pytest.mark.parametrize("name,arch,argv", [
    ("serve_vram_budget", "qwen30b-a3b", []),
    ("quickstart", "yi-9b", []),
    ("serve_http", "qwen2-0.5b", ["--port", "0"])])
def test_twin_prints_the_reference_lines_f32(name, arch, argv, monkeypatch):
    ref, twin = load(name), load(f"{name}_torch")
    same_weights_f32(monkeypatch, ref, twin, arch)
    want = run_reference(monkeypatch, ref, argv)
    res, got = run_main(twin.main, argv + ["--device", "cpu"])
    assert in_order(got) == in_order(want)
    assert isinstance(res, dict) and res
    # the returned dict says what the lines say
    if name == "serve_vram_budget":
        assert [r["identical"] for r in res["rows"]] == [True] * 3
        assert res["rows"][2]["streamed_bytes"] > 0
        assert res["rebudget"]["identical"] is True
    elif name == "quickstart":
        assert res["identical"] is True
        assert f"sample {res['generated'][0]}" in got[-3]
    else:
        assert res["stream_tokens"] == res["unary_tokens"]
        assert res["inflight_tokens"] == res["baseline_tokens"]
        assert (res["completed"], res["reconciles"]) == (4, True)


# ------------------------------------------------- bf16: the twins' own flags
@pytest.mark.parametrize("name,argv", [
    ("serve_vram_budget", []),
    ("serve_vram_budget", ["--arch", "qwen2-0.5b"]),
    ("quickstart", []),
    ("serve_http", ["--port", "0"])])
def test_twin_identity_flags_bf16(name, argv):
    twin = load(f"{name}_torch")
    res, lines = run_main(twin.main, argv + ["--device", "cpu"])
    if name == "serve_vram_budget":
        assert all(line.endswith("tokens identical across budgets: True")
                   for line in lines[:3])
        assert lines[3].endswith(
            "remaining tokens identical to uninterrupted runs: True")
        assert [r["identical"] for r in res["rows"]] == [True] * 3
        assert res["rows"][2]["streamed_bytes"] > 0
    elif name == "quickstart":
        assert lines[-1] == "    tokens identical across budgets: True"
        assert res["identical"] is True
    else:
        assert "    stream and unary token-identical: OK" in lines
        assert "    in-flight stream token-identical across the swap: OK" \
            in lines
        assert (res["completed"], res["reconciles"]) == (4, True)
        assert lines[-1] == "done."


@pytest.mark.parametrize("name", SERVING)
def test_full_selects_the_published_config(name, monkeypatch):
    """``--full`` serves ``get_config(arch)``: with ``get_smoke_config``
    made to raise and ``get_config`` answering the smoke config, the twin
    still runs through."""
    twin = load(f"{name}_torch")
    calls = []

    def published(arch):
        calls.append(arch)
        return torch_smoke(arch)

    def smoke(arch):
        raise AssertionError("--full read the smoke config")
    monkeypatch.setattr(twin, "get_config", published)
    monkeypatch.setattr(twin, "get_smoke_config", smoke)
    argv = ["--arch", "qwen2-0.5b", "--full", "--device", "cpu"]
    if name == "serve_http":
        argv += ["--port", "0"]
    res, _ = run_main(twin.main, argv)
    assert res["arch"] == "qwen2-0.5b-smoke"
    assert "qwen2-0.5b" in calls
    if name == "quickstart":
        assert res["identical"] is True


# ------------------------------------------------- no card, no CPU fallback
@pytest.mark.parametrize("name", SERVING)
def test_twin_raises_without_cuda(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    twin = load(f"{name}_torch")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        twin.main(["--arch", "qwen2-0.5b"])


# ------------------------------------------------- imports
@pytest.mark.parametrize("name", TWINS)
def test_twin_imports_neither_jax_nor_repro(name):
    path = EXAMPLES / f"{name}_torch.py"
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            roots.add((node.module or "").split(".")[0])
    assert "repro_torch" in roots
    assert not roots & {"jax", "jaxlib", "repro", "flax", "optax"}
