"""Counts on fake tensors against counts on real CPU tensors
(``repro_torch.launch.counting``, ``launch/dryrun.py``).

- for a smoke config of each family and each step (train with remat
  full, prefill, decode) the count on fake tensors equals the count on
  real CPU tensors exactly: flops, bytes, peak live bytes, argument and
  output bytes (MoE: on a batch whose tokens route to every expert in
  every layer, since a fake count takes every expert as routed, and the
  real run is checked to have routed to all);
- the flops are ``FlopCounterMode``'s;
- nothing is stored: a fake count fails on a real op output, and a full
  config's cell (qwen2-0.5b decode_32k, 52 GB of arguments) is counted
  here on fake tensors.

Counts are integers and are compared exactly.
"""
import numpy as np
import pytest
import torch

from repro_torch.config import ShapeConfig
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.launch import counting, dryrun
from repro_torch.models import api
from repro_torch.models import mlp as tmlp
from repro_torch.models.common import tree_leaves, tree_map
from repro_torch.optim import OptConfig, adamw_init

torch.set_num_threads(1)

FAMILY_ARCHS = ("qwen2-0.5b", "qwen30b-a3b", "qwen2-vl-7b",
                "musicgen-medium", "zamba2-7b", "xlstm-125m")
KINDS = ("train", "prefill", "decode")


def _same(a, b):
    """Two counts' integers, every field but the op count (a fake tensor
    answers some queries, such as its device, through the dispatcher)."""
    da, db = a.as_dict(), b.as_dict()
    for d in (da, db):
        d.pop("fake")
        d.pop("n_ops")
    return da, db


def _real_like(tree, rng):
    """Real CPU tensors for a tree of specs: floats drawn small (so the
    loss and the SSD stay finite), ints as ids under every smoke vocab."""
    def one(t):
        if t.dtype in (torch.int32, torch.int64):
            return torch.from_numpy(rng.randint(0, 64, t.shape)).to(t.dtype)
        a = rng.randn(*t.shape).astype(np.float32) * 0.05
        return torch.from_numpy(a).to(t.dtype)
    return tree_map(one, tree)


# (B, S) of each step; the MoE's 128 tokens route to all 8 experts in
# every layer
STEP_SHAPES = {"train": (2, 32), "prefill": (2, 32), "decode": (4, 32)}
MOE_SHAPES = {"train": (4, 32), "prefill": (4, 32), "decode": (128, 32)}


def _step_args(cfg, shape, real):
    step, args, call, _, _ = dryrun.build_cell(cfg, shape, "cpu")
    if not real:
        return step, args, call
    rng = np.random.RandomState(0)
    args = tuple(_real_like(a, rng) for a in args)
    if shape.kind == "train":   # fresh AdamW state, not random moments
        args = (args[0], adamw_init(OptConfig(), args[0]), args[2])
    if cfg.family == "vlm":     # the reference's 3D positions: arange
        B, S = shape.global_batch, shape.seq_len
        pos = torch.arange(S if shape.kind != "decode" else 1,
                           dtype=torch.int32)
        batch = args[2] if shape.kind == "train" else args[1]
        batch["positions"] = pos.expand(3, B, -1).contiguous()
    call = args if shape.kind != "decode" else args[:3] + (call[3],)
    return step, args, call


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_fake_count_equals_real_count(arch, kind, monkeypatch):
    cfg = get_smoke_config(arch)
    B, S = (MOE_SHAPES if cfg.moe else STEP_SHAPES)[kind]
    shape = ShapeConfig("t", kind, S, B)
    routed = []
    if cfg.moe is not None:
        real_routed = tmlp.routed_experts

        def spy(idx, n):
            out = real_routed(idx, n)
            routed.append(len(out))
            return out
        monkeypatch.setattr(tmlp, "routed_experts", spy)
    counts = {}
    for real in (True, False):
        step, args, call = _step_args(cfg, shape, real)
        with counting.count_step(*args) as rec:
            rec.outputs(step(*call))
        counts[real] = rec
    if cfg.moe is not None:     # every expert routed in the real run too
        assert routed and set(routed) == {cfg.moe.n_experts}
    a, b = _same(counts[True], counts[False])
    assert a == b
    assert counts[False].fake and not counts[True].fake
    assert a["flops"] > 0 and a["bytes_accessed"] > 0
    assert a["peak_live_bytes"] > a["argument_bytes"] > 0


def test_count_matches_flop_counter_mode():
    """The flops are ``FlopCounterMode``'s on a step with no kernel unit
    (a dense decode, T below the flash threshold)."""
    from torch.utils.flop_counter import FlopCounterMode
    cfg = get_smoke_config("qwen2-0.5b")
    step, args, call = _step_args(cfg, ShapeConfig("t", "decode", 32, 4),
                                  True)
    with counting.count_step(*args) as rec:
        step(*call)
    with FlopCounterMode(display=False) as fc:
        step(*call)
    assert rec.kernels == {} and rec.flops == fc.get_total_flops() > 0


def test_fake_count_fails_on_a_real_tensor():
    """A fake count asserts every op's output is fake: nothing is
    stored."""
    with api.spec_mode():
        x = torch.empty((4, 4))
    real = torch.ones(4)
    with counting.count_step(x) as rec:
        with pytest.raises(AssertionError, match="real tensor"):
            rec._op(torch.ops.aten.add.Tensor, (x, x), {}, real)


def test_full_config_cell_counted_without_storage():
    """qwen2-0.5b decode_32k at its published size: 52.5 GB of arguments
    (weights, the batch-128 cache of 32768 positions, tokens, pos),
    counted on fake tensors in seconds."""
    cfg = get_config("qwen2-0.5b")
    rec = dryrun.run_cell("qwen2-0.5b", "decode_32k", save=False,
                          device="cpu")
    L, B, S = cfg.n_layers, 128, 32768
    cache = 2 * L * B * cfg.n_kv_heads * S * cfg.resolved_head_dim * 2
    params = sum(counting.nbytes(t) for t in tree_leaves(
        api.param_specs(cfg, "cpu")))
    mem = rec["memory"]
    assert mem["argument_bytes"] == params + cache + B * 4 + 4
    assert mem["alias_bytes"] == cache
    assert mem["output_bytes"] == cache + B * cfg.vocab * 2
    assert rec["fits_card"] and rec["fake"] and rec["n_chips"] == 1
    # every product of the analytic count, less its norms and biases
    model = rec["model_flops_per_chip"]
    assert 0.9999 * model < rec["flops_per_chip"] < model
    assert rec["collectives"]["total_traffic_bytes"] == 0
