"""The port's dry-run counts against the JAX package, on the CPU.

- argument and output bytes: at the smoke configs of every family, for the
  train (remat full), prefill and decode steps, the port's count on fake
  tensors equals the reference's ``jax.jit(step).lower(...).compile()
  .memory_analysis()`` with its steps built with ``policy=None`` on one
  CPU device. The reference is jitted with ``keep_unused=True`` so that
  an argument its step never reads (the xLSTM's decode position) stays an
  argument, as it is one of the port's step; XLA's output size also holds
  the output tuple's table of 8-byte buffer pointers, one per leaf, which
  is taken off. Temporaries are not compared: an eager step frees and
  allocates op by op, XLA plans one buffer assignment, by design;
- ``depth_pair``: for every arch of ``list_archs(include_paper=True)`` the
  port's equals the reference's, read in a subprocess (the reference's
  ``launch/probe.py`` sets ``XLA_FLAGS``, ``REPRO_SCAN_UNROLL`` and
  ``REPRO_FORCE_REF_ATTN`` when imported, which must not reach this
  process);
- ``dryrun.model_flops`` equals ``benchmarks/roofline.py``'s
  ``model_flops_per_chip`` at ``chips=1`` for every cell.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

from benchmarks.roofline import model_flops_per_chip
from repro.config import SHAPES as JSHAPES
from repro.config import ShapeConfig as JShape
from repro.config import cells as jcells
from repro.configs import get_config as jget_config
from repro.configs import get_smoke_config as jsmoke
from repro.launch.steps import make_decode_step as jdecode
from repro.launch.steps import make_prefill_step as jprefill
from repro.launch.steps import make_train_step as jtrain
from repro.models.api import build_model as jbuild
from repro.models.api import input_specs as jinput_specs
from repro.optim import OptConfig as JOpt
from repro.optim import adamw_init as jadamw_init
from repro_torch.config import SHAPES, ShapeConfig, cells
from repro_torch.configs import get_config, get_smoke_config, list_archs
from repro_torch.launch import counting, dryrun, probe

ROOT = Path(__file__).resolve().parents[1]
FAMILY_ARCHS = ("qwen2-0.5b", "qwen30b-a3b", "qwen2-vl-7b",
                "musicgen-medium", "zamba2-7b", "xlstm-125m")
B, S = 2, 32


def _reference_memory(arch, kind):
    """(argument bytes, output bytes) of the reference's compiled step."""
    cfg = jsmoke(arch)
    shape = JShape("t", kind, S, B)
    ps = jax.eval_shape(jbuild(cfg).init, jax.random.PRNGKey(0))
    specs = jinput_specs(cfg, shape)
    if kind == "train":
        oc = JOpt()
        step = jtrain(cfg, None, oc, remat="full")
        args = (ps, jax.eval_shape(lambda p: jadamw_init(oc, p), ps),
                specs["batch"])
    elif kind == "prefill":
        step, args = jprefill(cfg, None), (ps, specs["batch"],
                                           specs["cache"])
    else:
        step = jdecode(cfg, None)
        args = (ps, specs["batch"], specs["cache"], specs["pos"])
    mem = jax.jit(step, keep_unused=True).lower(*args).compile() \
        .memory_analysis()
    n_out = len(jax.tree.leaves(jax.eval_shape(step, *args)))
    return mem.argument_size_in_bytes, mem.output_size_in_bytes - 8 * n_out


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_argument_and_output_bytes_match_reference(arch, kind):
    rec = dryrun.count_cell(arch, ShapeConfig("t", kind, S, B), "cpu",
                            cfg=get_smoke_config(arch))[0]
    assert rec.fake
    assert (rec.argument_bytes, rec.output_bytes) == \
        _reference_memory(arch, kind)


def test_depth_pair_matches_reference():
    code = ("import json, sys\n"
            "from repro.configs import get_config, list_archs\n"
            "from repro.launch.probe import depth_pair\n"
            "json.dump({a: list(depth_pair(get_config(a))) for a in "
            "list_archs(include_paper=True)}, sys.stdout)\n")
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]),
        "JAX_PLATFORMS": "cpu"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300, check=True)
    ref = json.loads(out.stdout)
    archs = list_archs(include_paper=True)
    assert sorted(ref) == sorted(archs)
    for arch in archs:
        assert list(probe.depth_pair(get_config(arch))) == ref[arch], arch
    # the subprocess's environment did not reach this process
    assert "REPRO_SCAN_UNROLL" not in os.environ
    assert "REPRO_FORCE_REF_ATTN" not in os.environ


def test_model_flops_match_roofline():
    assert cells() == jcells()
    for arch, shape in cells():
        want = model_flops_per_chip(jget_config(arch), JSHAPES[shape],
                                    chips=1)
        assert dryrun.model_flops(get_config(arch), SHAPES[shape]) == want


def test_collectives_are_zero_on_one_card():
    rec = dryrun.run_cell("xlstm-125m", "decode_32k", save=False,
                          device="cpu")
    assert rec["collectives"]["total_traffic_bytes"] == 0
    assert rec["collectives"]["n_ops"] == 0
    assert rec["n_chips"] == 1
    assert rec["memory"]["host_temp_bytes"] == 0
    assert np.isfinite(rec["model_flops_per_chip"])
    assert counting.COLLECTIVES["total_traffic_bytes"] == 0
