"""The vision and training examples' PyTorch twins against the reference
examples, on the CPU: ``examples/vlm_budget_torch.py`` and
``train_lm_torch.py``, each loaded by file path beside its reference and
run in process with ``--device cpu``.

- vlm_budget: the analytic VRAM grid, the 1440p reduction and the
  planning-only qwen2-vl-7b lines equal the reference's character for
  character. The encoders' weights differ (a ``torch.Generator`` against
  the reference's PRNG), so the twin's flash encodes are held to the plain
  one within 1e-5 on their own; each encode gets its own copy of the
  patches (the encoder overwrites them).
- train_lm: with the smoke config in f32 in both namespaces and the
  reference's drawn weights handed to the twin, the same events, the same
  number of log entries, each step's lr within 1e-7 and its loss and
  gradient norm within 1e-4 relative; at the defaults (bf16) a fault's
  replayed steps are bit-equal to their first pass and the loss falls.
- Without CUDA and without ``--device cpu`` each twin raises.
"""
import contextlib
import importlib.util
import io
import sys
from pathlib import Path
from types import SimpleNamespace

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
FLASH_TOL = 1e-5
LR_TOL = 1e-7
TRAIN_RTOL = 1e-4
TRAIN_ARGS = ["--steps", "30", "--inject-fault", "25"]


def load(name):
    spec = importlib.util.spec_from_file_location(
        f"example_{name}", EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def printed(fn, *args):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = fn(*args)
    return res, buf.getvalue().splitlines()


# ------------------------------------------------------------ vlm_budget
@pytest.fixture(scope="module")
def vlm_runs():
    ref, twin = load("vlm_budget"), load("vlm_budget_torch")
    argv = sys.argv
    sys.argv = ["vlm_budget.py"]
    try:
        _, want = printed(ref.main)
    finally:
        sys.argv = argv
    res, got = printed(twin.main, ["--device", "cpu"])
    return want, res, got


def test_vlm_twin_grid_and_plans_equal_the_reference(vlm_runs):
    want, res, got = vlm_runs
    n = len(res["flash"])
    assert len(got) == len(want)
    # everything after the encodes is analytic or planned: equal lines
    assert got[n:] == want[n:]
    assert [row["res"] for row in res["grid"]] == \
        ["480p", "720p", "1080p", "1440p"]
    assert [p["budget_gb"] for p in res["plans"]] == [4.0, 8.0]


def test_vlm_twin_flash_matches_plain(vlm_runs):
    want, res, got = vlm_runs
    assert [f["q_chunk"] for f in res["flash"]] == [32, 64, 128]
    for f, line, ref_line in zip(res["flash"], got, want):
        assert f["max_err"] <= FLASH_TOL
        assert line == (f"flash q_chunk={f['q_chunk']:4d}: max err vs full "
                        f"attention {f['max_err']:.2e}")
        # the reference's own line names the same chunk
        assert ref_line.startswith(f"flash q_chunk={f['q_chunk']:4d}: ")


def test_vlm_twin_encodes_its_own_copy(monkeypatch):
    """Each encode is handed a fresh copy of the patches: the encoder
    writes into what it is given, and the plain reference's result must
    not feed the flash encodes."""
    twin = load("vlm_budget_torch")
    seen = []
    real = twin.vision_encode

    def spy(params, vc, patches, **kw):
        seen.append(patches.clone())
        return real(params, vc, patches, **kw)
    monkeypatch.setattr(twin, "vision_encode", spy)
    printed(twin.main, ["--device", "cpu"])
    assert len(seen) == 4
    for p in seen[1:]:
        assert torch.equal(p, seen[0])


# ------------------------------------------------------------ train_lm
def test_train_twin_matches_the_reference_f32(monkeypatch, tmp_path):
    ref, twin = load("train_lm"), load("train_lm_torch")
    jcfg = jax_smoke("yi-9b").replace(dtype="float32")
    tcfg = torch_smoke("yi-9b").replace(dtype="float32")
    monkeypatch.setattr(ref, "get_smoke_config", lambda a: jcfg)
    monkeypatch.setattr(twin, "get_smoke_config", lambda a: tcfg)
    tp = params_from_numpy(jax.tree.map(
        np.asarray, jax_build(jcfg).init(jax.random.PRNGKey(0))))
    monkeypatch.setattr(twin, "build_model", lambda cfg: SimpleNamespace(
        init=lambda gen: tp))
    # the reference's driver, kept to read its log and events
    drivers = []
    real = ref.TrainDriver

    def keep(*a, **kw):
        drivers.append(real(*a, **kw))
        return drivers[-1]
    monkeypatch.setattr(ref, "TrainDriver", keep)
    monkeypatch.setattr(sys, "argv", ["train_lm.py", *TRAIN_ARGS,
                                      "--ckpt-dir", str(tmp_path / "ref")])
    _, want = printed(ref.main)
    res, got = printed(twin.main, TRAIN_ARGS + [
        "--ckpt-dir", str(tmp_path / "twin"), "--device", "cpu"])
    (drv,) = drivers
    assert res["events"] == drv.events
    assert [k for _, k, _ in res["events"]] == ["fault", "restart"]
    assert len(res["log"]) == len(drv.metrics_log) == 35
    assert res["n_params"] == sum(x.size for x in
                                  jax.tree.leaves(drv.state["params"]))
    assert got[0] == want[0]          # the parameter count's line
    assert got[-1] == want[-1]        # the events' line
    for mine, theirs in zip(res["log"], drv.metrics_log):
        assert abs(mine["lr"] - float(theirs["lr"])) <= LR_TOL
        for key in ("loss", "grad_norm"):
            want_v = float(theirs[key])
            assert abs(mine[key] - want_v) <= TRAIN_RTOL * abs(want_v), key


def test_train_twin_defaults_restart_and_replay(tmp_path):
    """bf16, the smoke preset: the fault at step 25 restores the step-20
    checkpoint, the replayed steps 20-24 give their first pass's losses
    bit for bit, and the loss falls."""
    twin = load("train_lm_torch")
    res, lines = printed(twin.main, TRAIN_ARGS + [
        "--ckpt-dir", str(tmp_path), "--device", "cpu"])
    assert [(s, k) for s, k, _ in res["events"]] == [(25, "fault"),
                                                     (20, "restart")]
    losses = [m["loss"] for m in res["log"]]
    assert len(losses) == 35 and res["steps"] == 30
    assert losses[25:30] == losses[20:25]
    assert all(np.isfinite(losses))
    assert np.mean(losses[-3:]) < losses[0]
    assert lines[0] == f"model yi-9b-smoke: {res['n_params']/1e6:.1f}M params"
    assert lines[-2].startswith("final loss ")


# ------------------------------------------------------------ no card
@pytest.mark.parametrize("name,argv", [("vlm_budget", []),
                                       ("train_lm", ["--steps", "1"])])
def test_twin_raises_without_cuda(name, argv, monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    twin = load(f"{name}_torch")
    if name == "train_lm":
        argv = argv + ["--ckpt-dir", str(tmp_path / "ckpt")]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        twin.main(argv)
    assert not (tmp_path / "ckpt").exists()
