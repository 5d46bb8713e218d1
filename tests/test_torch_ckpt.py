"""The port's checkpoints, data pipeline and fault-tolerant driver against
the JAX package, on the CPU.

- a checkpoint written by ``repro`` restores into ``repro_torch`` bit for
  bit (bf16, f32, int32, 0-dim and nested leaves), and one written by the
  port restores into ``repro``; the manifests agree (tree string, shapes,
  dtype names); retention and async saves as the reference's;
- ``DataPipeline`` batches are byte-equal to the reference's for several
  seeds and steps, per-process slices and the audio family's codebooks;
- ``TrainDriver``: restart from a fault with exact replay, too many faults
  raising, and the straggler watch, mirroring ``tests/test_driver.py``;
  a full train state (params, AdamW state) through a save and a restore.
"""
import json
import os
import time

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.checkpoint import load_checkpoint as jax_load
from repro.checkpoint import save_checkpoint as jax_save
from repro.configs import get_smoke_config as jax_smoke
from repro.data import DataPipeline as JaxPipeline
from repro_torch.checkpoint import (CheckpointManager, latest_step,
                                    load_checkpoint, save_checkpoint)
from repro_torch.configs import get_smoke_config as torch_smoke
from repro_torch.data import DataPipeline, make_batch
from repro_torch.models import build_model
from repro_torch.models.common import tree_flatten
from repro_torch.optim import OptConfig, adamw_init
from repro_torch.runtime import FaultInjector, TrainDriver

torch.set_num_threads(1)


def np_tree(seed=0):
    """A tree of numpy leaves with the dtypes a train state holds."""
    rng = np.random.RandomState(seed)
    return {"params": {"w": rng.randn(5, 3).astype(ml_dtypes.bfloat16),
                       "b": rng.randn(3).astype(np.float32),
                       "layers": {"k": rng.randn(2, 4, 2)
                                  .astype(ml_dtypes.bfloat16)}},
            "opt": {"m": rng.randn(5, 3).astype(np.float32),
                    "step": np.asarray(7, np.int32)},
            "codes": rng.randint(-127, 128, (4, 4)).astype(np.int8)}


def to_torch_tree(tree):
    from repro_torch.models.api import params_from_numpy
    return params_from_numpy(tree)


def assert_same_bits(np_leaf, t):
    a = np.asarray(np_leaf)
    assert list(t.shape) == list(a.shape)
    assert str(t.dtype).split(".")[-1] == str(a.dtype)
    got = t.view(torch.int16).numpy().view(np.uint16) \
        if t.dtype == torch.bfloat16 else t.numpy()
    want = a.view(np.uint16) if a.dtype == ml_dtypes.bfloat16 else a
    np.testing.assert_array_equal(got, want)


def test_reference_checkpoint_restores_in_port(tmp_path):
    tree = np_tree()
    jax_save(str(tmp_path), 5, jax.tree.map(jnp.asarray, tree),
             extra={"note": "ref"})
    like = to_torch_tree(np_tree(1))
    restored, step, extra = load_checkpoint(str(tmp_path), like)
    assert step == 5 and extra == {"note": "ref"}
    for a, t in zip(jax.tree.leaves(tree), tree_flatten(restored)[0]):
        assert_same_bits(a, t)


def test_port_checkpoint_restores_in_reference(tmp_path):
    tree = np_tree(2)
    save_checkpoint(str(tmp_path), 9, to_torch_tree(tree), extra={"k": 1})
    restored, step, extra = jax_load(str(tmp_path),
                                     jax.tree.map(jnp.asarray, np_tree(3)))
    assert step == 9 and extra == {"k": 1}
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(restored)):
        assert np.asarray(b).dtype == np.asarray(a).dtype
        assert np.asarray(b).shape == np.asarray(a).shape
        assert np.asarray(b).tobytes() == np.asarray(a).tobytes()


def test_manifests_agree(tmp_path):
    tree = np_tree(4)
    jax_save(str(tmp_path / "ref"), 1, jax.tree.map(jnp.asarray, tree))
    save_checkpoint(str(tmp_path / "port"), 1, to_torch_tree(tree))
    man = [json.load(open(tmp_path / d / "step_00000001" / "manifest.json"))
           for d in ("ref", "port")]
    for key in ("step", "treedef", "n_leaves", "shapes", "dtypes", "extra"):
        assert man[0][key] == man[1][key], key
    files = [np.load(tmp_path / d / "step_00000001" / "arrays.npz")
             for d in ("ref", "port")]
    assert sorted(files[0].files) == sorted(files[1].files)
    for k in files[0].files:
        np.testing.assert_array_equal(files[0][k], files[1][k])


def test_restore_onto_a_device_and_structure_check(tmp_path):
    tree = to_torch_tree(np_tree(5))
    save_checkpoint(str(tmp_path), 3, tree)
    restored, _, _ = load_checkpoint(str(tmp_path), tree, device="cpu")
    for a, b in zip(tree_flatten(tree)[0], tree_flatten(restored)[0]):
        assert torch.equal(a, b) and b.device.type == "cpu"
    with pytest.raises(AssertionError, match="leaves"):
        load_checkpoint(str(tmp_path), {"only": torch.zeros(1)})
    with pytest.raises(FileNotFoundError):
        load_checkpoint(str(tmp_path / "none"), tree)


def test_manager_retention_and_async(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2, async_save=True)
    tree = {"w": torch.zeros(4)}
    for s in range(5):
        mgr.save(s, {"w": tree["w"] + s})
    mgr.wait()
    steps = sorted(int(d.split("_")[1]) for d in os.listdir(tmp_path)
                   if d.startswith("step_"))
    assert steps[-1] == 4 and len(steps) <= 2
    assert latest_step(str(tmp_path)) == 4
    restored, step, _ = mgr.restore(tree)
    assert step == 4 and torch.equal(restored["w"], torch.full((4,), 4.0))
    assert not any(d.endswith(".tmp") for d in os.listdir(tmp_path))


def test_train_state_roundtrip(tmp_path):
    cfg = torch_smoke("qwen30b-a3b")
    params = build_model(cfg).init(torch.Generator().manual_seed(0))
    state = {"params": params, "opt": adamw_init(OptConfig(), params)}
    save_checkpoint(str(tmp_path), 0, state)
    restored, _, _ = load_checkpoint(str(tmp_path), state)
    for a, b in zip(tree_flatten(state)[0], tree_flatten(restored)[0]):
        assert a.dtype == b.dtype and torch.equal(a, b)


# ---------------------------------------------------------------- data
@pytest.mark.parametrize("arch", ["yi-9b", "musicgen-medium", "qwen2-0.5b"])
@pytest.mark.parametrize("seed", [0, 3])
def test_pipeline_byte_equal_to_reference(arch, seed):
    jp = JaxPipeline(jax_smoke(arch), 24, 4, seed=seed, process_index=0,
                     process_count=1)
    tp = DataPipeline(torch_smoke(arch), 24, 4, seed=seed)
    for step in (0, 1, 17):
        a, b = jp.batch_at(step), tp.batch_at(step)
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
            assert a[k].tobytes() == b[k].tobytes()
    assert jp.next_batch()["tokens"].tobytes() == \
        tp.next_batch()["tokens"].tobytes()


def test_pipeline_process_slices_match_reference():
    cfg_j, cfg_t = jax_smoke("yi-9b"), torch_smoke("yi-9b")
    for pi in (0, 1):
        a = JaxPipeline(cfg_j, 32, 8, seed=3, process_index=pi,
                        process_count=2).batch_at(5)
        b = DataPipeline(cfg_t, 32, 8, seed=3, process_index=pi,
                         process_count=2).batch_at(5)
        assert a["tokens"].tobytes() == b["tokens"].tobytes()
    b = make_batch(cfg_t, 16, 2, seed=1)
    np.testing.assert_array_equal(b["tokens"][:, 1:], b["labels"][:, :-1])


# ---------------------------------------------------------------- driver
def quad_pipeline():
    class P:
        def batch_at(self, step):
            rng = np.random.RandomState(step)
            return {"x": rng.randn(4).astype(np.float32)}
    return P()


def quad_step(state, batch):
    """Toy quadratic descent step with a deterministic trace."""
    w = state["w"]
    g = w - torch.from_numpy(batch["x"])
    w = w - 0.1 * g
    return {"w": w, "n": state["n"] + 1}, {"loss": torch.sum(g * g),
                                           "n": state["n"] + 1}


def quad_state():
    return {"w": torch.zeros(4), "n": torch.tensor(0, dtype=torch.int32)}


def test_restart_from_fault(tmp_path):
    drv = TrainDriver(quad_step, quad_state(), quad_pipeline(),
                      str(tmp_path), ckpt_every=5,
                      fault_injector=FaultInjector(fail_at=[7]))
    drv.run(12)
    kinds = [k for _, k, _ in drv.events]
    assert "fault" in kinds and "restart" in kinds
    assert drv.step == 12
    assert [s for s, k, _ in drv.events if k == "restart"] == [5]
    # replay determinism: the final state equals an uninterrupted run
    drv2 = TrainDriver(quad_step, quad_state(), quad_pipeline(),
                       str(tmp_path / "b"), ckpt_every=5)
    drv2.run(12)
    assert torch.equal(drv.state["w"], drv2.state["w"])
    assert int(drv.state["n"]) == 12
    # the replayed steps' metrics equal the first run's
    assert drv.metrics_log[5] == drv.metrics_log[7]


def test_too_many_faults_raises(tmp_path):
    drv = TrainDriver(quad_step, quad_state(), quad_pipeline(),
                      str(tmp_path))
    drv.fault = FaultInjector(fail_at=[1, 2, 3, 4, 5])
    with pytest.raises(RuntimeError, match="injected fault"):
        drv.run(10, max_restarts=3)


def test_straggler_detection(tmp_path):
    calls = {"n": 0}

    def slow_step(s, b):
        calls["n"] += 1
        if calls["n"] == 9:
            time.sleep(0.3)
        return quad_step(s, b)

    drv = TrainDriver(slow_step, quad_state(), quad_pipeline(),
                      str(tmp_path), ckpt_every=100, straggler_factor=3.0)
    drv.run(12)
    assert any(k == "straggler" for _, k, _ in drv.events)
    assert len(drv.step_seconds) == 12


def test_driver_has_no_remesh():
    """One card has no mesh to re-shard onto (module docstring)."""
    assert not hasattr(TrainDriver, "remesh")
