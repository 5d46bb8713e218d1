"""AdamW with a cosine schedule and global-norm clipping, on dict trees of
tensors: the reference's ``optim/adamw.py`` op for op.

Every scalar is a 0-dim f32 tensor on the step's device, as the
reference's weak-typed scalars are f32: bias corrections, the learning
rate, the clip scale and the constants. On CUDA PyTorch divides by a
Python scalar as a multiply by its reciprocal, which can differ from true
division by one ulp; a 0-dim tensor keeps the division exact. Leaves are
walked in ``jax.tree_util``'s order (``common.tree_flatten``), so the
global norm sums them in the reference's order. Weight decay applies to
leaves of ndim >= 2 only; ``state_dtype`` sets m and v's dtype.

The reference's ``offload_states`` (its launcher maps the state to
``pinned_host`` memory, ZeRO-offload) has no runtime counterpart on one
card: the state stays on the params' device, and ``OptConfig`` has no
such field. ``launch/dryrun.py`` counts the state its ``offload_opt``
override would keep off the card (``host_argument_bytes``), as the
reference only compiles that path.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.models.common import tree_flatten, tree_map, tree_unflatten

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


@dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    state_dtype: str = "float32"


def _c(value, device) -> torch.Tensor:
    """A constant as a 0-dim f32 tensor (see the module docstring)."""
    return torch.tensor(value, dtype=torch.float32, device=device)


def cosine_lr(oc: OptConfig, step) -> torch.Tensor:
    """Linear warmup to ``oc.lr`` over ``warmup_steps``, then a cosine to
    0 at ``total_steps``; a 0-dim f32 tensor on ``step``'s device."""
    step = torch.as_tensor(step).to(torch.float32)
    dev = step.device
    warm = torch.minimum(step / _c(max(oc.warmup_steps, 1), dev),
                         _c(1.0, dev))
    prog = torch.clamp((step - _c(oc.warmup_steps, dev))
                       / _c(max(oc.total_steps - oc.warmup_steps, 1), dev),
                       0.0, 1.0)
    return _c(oc.lr, dev) * warm * _c(0.5, dev) \
        * (_c(1.0, dev) + torch.cos(_c(np.pi, dev) * prog))


def adamw_init(oc: OptConfig, params):
    """Zero m and v in ``state_dtype`` beside each leaf, and step 0
    (a 0-dim int32 on the params' device)."""
    dt = _DTYPES[oc.state_dtype]
    leaves, _ = tree_flatten(params)
    dev = leaves[0].device if leaves else torch.device("cpu")
    return {"m": tree_map(lambda p: torch.zeros(p.shape, dtype=dt,
                                                device=p.device), params),
            "v": tree_map(lambda p: torch.zeros(p.shape, dtype=dt,
                                                device=p.device), params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves (in flatten order) of each leaf's f32
    sum of squares."""
    leaves, _ = tree_flatten(tree)
    sq = _c(0.0, leaves[0].device)
    for x in leaves:
        sq = sq + torch.sum(torch.square(x.to(torch.float32)))
    return torch.sqrt(sq)


def adamw_update(oc: OptConfig, grads, state, params):
    """One AdamW step. Returns (new_params, new_state, metrics) with
    metrics ``{"grad_norm", "lr"}`` as 0-dim tensors. New trees are made
    leaf by leaf (the f32 temporaries of one leaf at a time); the inputs
    are left as they are."""
    step = state["step"] + 1
    dev = step.device
    lr = cosine_lr(oc, step)
    gnorm = global_norm(grads)
    scale = torch.minimum(_c(1.0, dev), _c(oc.clip_norm, dev)
                          / torch.maximum(gnorm, _c(1e-9, dev)))
    sdt = _DTYPES[oc.state_dtype]
    t = step.to(torch.float32)
    bc1 = _c(1.0, dev) - torch.pow(_c(oc.b1, dev), t)
    bc2 = _c(1.0, dev) - torch.pow(_c(oc.b2, dev), t)
    b1, b2 = _c(oc.b1, dev), _c(oc.b2, dev)
    one_b1, one_b2 = _c(1 - oc.b1, dev), _c(1 - oc.b2, dev)
    eps = _c(oc.eps, dev)
    wd = {True: _c(oc.weight_decay, dev), False: _c(0.0, dev)}

    def upd(g, m, v, p):
        g = g.to(torch.float32) * scale
        m32 = b1 * m.to(torch.float32) + one_b1 * g
        v32 = b2 * v.to(torch.float32) + one_b2 * g * g
        mhat = m32 / bc1
        vhat = v32 / bc2
        delta = mhat / (torch.sqrt(vhat) + eps)
        # decoupled weight decay on matrices only (ndim >= 2)
        pf = p.to(torch.float32)
        new_p = pf - lr * (delta + wd[p.ndim >= 2] * pf)
        return new_p.to(p.dtype), m32.to(sdt), v32.to(sdt)

    g_leaves, treedef = tree_flatten(grads)
    outs = [upd(*xs) for xs in zip(g_leaves, tree_flatten(state["m"])[0],
                                   tree_flatten(state["v"])[0],
                                   tree_flatten(params)[0])]
    new_params, new_m, new_v = (tree_unflatten(treedef, [o[i] for o in outs])
                                for i in range(3))
    return new_params, {"m": new_m, "v": new_v, "step": step}, \
        {"grad_norm": gnorm, "lr": lr}
