"""The port's gradients against the JAX package, on the CPU, at the smoke
configs of every arch.

- ``jax.value_and_grad`` of the reference's ``Model.loss`` against the
  port's loss and ``torch.autograd.grad`` for every arch of
  ``list_archs(include_paper=True)``: in f32 the loss within 1e-5 and each
  grad leaf within 1e-5 relative L2; in bf16 the loss within 2e-2 and each
  leaf as close to the f32 gradient as the reference's own bf16 gradient
  is, up to 2e-2 (relative L2: port-vs-f32 <= 2 x reference-vs-f32 +
  2e-2; both packages round bf16 at other places, and at smoke widths the
  reference's own bf16 grads sit 1-15% from its f32 ones). The hybrid's
  and the xLSTM's backward run through the SSD's out-of-place forms.
- remat ``"none"``, ``"full"`` and ``"dots"`` give bit-equal grads.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import list_archs
from repro.models import build_model as jax_build
from repro_torch.launch import steps
from repro_torch.models import build_model as torch_build
from repro_torch.models.common import tree_flatten
from test_torch_train import (BF16_TOL, F32_TOL, as_np, batch_np, bridge,
                              configs, port_loss_fn, rel_l2, to_jax,
                              to_torch)

torch.set_num_threads(1)


# ---------------------------------------------------------------- grads
ARCHS = list_archs(include_paper=True)


def _grads(arch, dtype):
    """(reference loss, reference grad leaves, port loss, port grad
    leaves) for the arch's smoke config in ``dtype``."""
    jc, tc = configs(arch, dtype)
    jm, tm = jax_build(jc), torch_build(tc)
    jp = jm.init(jax.random.PRNGKey(0))
    b = batch_np(jc)
    jl, jg = jax.value_and_grad(jm.loss)(jp, to_jax(b, jc.dtype))
    tl, tg = steps.value_and_grad(port_loss_fn(tm), bridge(jp),
                                  to_torch(b, dtype))
    return (float(jl), [np.asarray(g, np.float32) for g in
                        jax.tree.leaves(jg)],
            float(tl), [as_np(g) for g in tree_flatten(tg)[0]])


@pytest.mark.parametrize("arch", ARCHS)
def test_value_and_grad_matches_reference(arch):
    jl32, jg32, tl32, tg32 = _grads(arch, "float32")
    assert len(jg32) == len(tg32)
    assert abs(tl32 - jl32) <= F32_TOL * abs(jl32)
    for i, (a, g) in enumerate(zip(jg32, tg32)):
        assert a.shape == g.shape, (arch, i)
        assert rel_l2(g, a) <= F32_TOL, (arch, "f32 leaf", i, rel_l2(g, a))
    jl16, jg16, tl16, tg16 = _grads(arch, "bfloat16")
    assert abs(tl16 - jl16) <= BF16_TOL * abs(jl16)
    for i, (a16, g16, a32) in enumerate(zip(jg16, tg16, jg32)):
        assert np.isfinite(g16).all()
        lim = 2 * rel_l2(a16, a32) + BF16_TOL
        assert rel_l2(g16, a32) <= lim, (arch, "bf16 leaf", i,
                                         rel_l2(g16, a32), lim)


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "qwen30b-a3b", "zamba2-7b",
                                  "xlstm-125m", "musicgen-medium"])
def test_remat_policies_give_equal_grads(arch):
    _, tc = configs(arch, "float32")
    model = torch_build(tc)
    params = model.init(torch.Generator().manual_seed(0))
    b = to_torch(batch_np(tc), "float32")
    base = None
    for remat in ("none", "full", "dots"):
        loss, grads = steps.value_and_grad(port_loss_fn(model, remat),
                                           params, b)
        leaves = tree_flatten(grads)[0]
        if base is None:
            base = (loss, leaves)
            continue
        assert torch.equal(loss, base[0]), remat
        for g, g0 in zip(leaves, base[1]):
            assert torch.equal(g, g0), remat


def test_remat_rejects_unknown_policy():
    _, tc = configs("qwen2-0.5b", "float32")
    model = torch_build(tc)
    params = model.init(torch.Generator().manual_seed(0))
    b = to_torch(batch_np(tc), "float32")
    with pytest.raises(ValueError, match="remat"):
        steps.value_and_grad(port_loss_fn(model, "some"), params, b)
