"""Step builders shared by the launchers: the reference's
``launch/steps.py`` with PyTorch's autograd in place of
``jax.value_and_grad``.

``make_train_step`` differentiates the functional ``Model.apply`` with
``torch.autograd.grad`` over leaf tensors made from the param tree (each
float leaf detached and set to require grad; no copy). The serving
``nn.Module``s stay frozen and under ``no_grad``. A param tree with an
integer leaf (``weight_quant`` int8 / int4, ``expert_quant``) raises: K2
and K3 take no gradient, and the reference cannot differentiate integer
leaves either. The reference's sharding ``policy`` has no counterpart on
one card.
"""
from __future__ import annotations

import os

import torch

from repro_torch.models.api import build_model, cross_entropy
from repro_torch.models.common import tree_flatten, tree_map, tree_unflatten
from repro_torch.optim import OptConfig, adamw_update


def _check_trainable(leaves):
    bad = [x.dtype for x in leaves if not x.is_floating_point()]
    if bad:
        raise ValueError(f"the param tree holds integer leaves ({bad[0]}): "
                         "a quantised config cannot be trained (K2 and K3 "
                         "take no gradient)")


def value_and_grad(loss_fn, params, batch):
    """(loss, grads) of ``loss_fn(params, batch)``: grads a tree like
    ``params`` in each leaf's dtype (zeros for a leaf the loss does not
    reach)."""
    leaves, treedef = tree_flatten(params)
    _check_trainable(leaves)
    req = [x.detach().requires_grad_(True) for x in leaves]
    with torch.enable_grad():
        loss = loss_fn(tree_unflatten(treedef, req), batch)
        grads = torch.autograd.grad(loss, req, allow_unused=True)
    grads = [torch.zeros_like(x) if g is None else g
             for g, x in zip(grads, leaves)]
    return loss.detach(), tree_unflatten(treedef, grads)


def split_batch(batch, n, i):
    """Microbatch ``i`` of ``n``: batch-major leaves split along dim 0, the
    vlm's (3, B, T) positions along dim 1."""
    B = batch["tokens"].shape[0]

    def part(x):
        if x.shape[0] == B:
            return x.reshape(n, B // n, *x.shape[1:])[i]
        return x.reshape(x.shape[0], n, B // n, *x.shape[2:])[:, i]
    return {k: part(v) for k, v in batch.items()}


def make_train_step(cfg, oc: OptConfig = None, remat="full",
                    microbatches: int = 1):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``. microbatches > 1: gradient accumulation, the batch split
    along its leading dim (the vlm's positions along dim 1) and the
    passes run one after another, as the reference scans them: grads
    summed in the param dtype (or f32 with ``REPRO_ACCUM_DTYPE=float32``),
    the loss summed in f32; then loss / n, and grads / n in f32 cast to
    bf16."""
    model = build_model(cfg)
    oc = oc or OptConfig()

    def loss_fn(p, b):
        logits, _ = model.apply(p, b, remat=remat)
        return cross_entropy(cfg, logits, b)

    def train_step(params, opt_state, batch):
        if microbatches == 1:
            loss, grads = value_and_grad(loss_fn, params, batch)
        else:
            n = microbatches
            acc_f32 = os.environ.get("REPRO_ACCUM_DTYPE", "param") \
                == "float32"
            leaves, _ = tree_flatten(params)
            loss = torch.zeros((), dtype=torch.float32,
                               device=leaves[0].device)
            grads = tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32 if acc_f32 else p.dtype,
                device=p.device), params)
            for i in range(n):
                l_i, g_i = value_and_grad(loss_fn, params,
                                          split_batch(batch, n, i))
                loss = loss + l_i
                g_leaves, treedef = tree_flatten(grads)
                grads = tree_unflatten(treedef, [
                    a + g for a, g in zip(g_leaves, tree_flatten(g_i)[0])])
                del g_i
            n_t = torch.tensor(n, dtype=torch.float32, device=loss.device)
            loss = loss / n_t
            grads = tree_map(lambda g: (g.to(torch.float32) / n_t)
                             .to(torch.bfloat16), grads)
        params2, opt_state2, metrics = adamw_update(oc, grads, opt_state,
                                                    params)
        metrics["loss"] = loss
        return params2, opt_state2, metrics

    return train_step


def make_loss_step(cfg, remat="none"):
    model = build_model(cfg)

    def loss_step(params, batch):
        logits, _ = model.apply(params, batch, remat=remat)
        return cross_entropy(cfg, logits, batch)

    return loss_step


def make_prefill_step(cfg):
    model = build_model(cfg)

    def prefill_step(params, batch, cache):
        logits, cache = model.apply(params, batch, cache=cache, cache_pos=0)
        return logits[:, -1:], cache

    return prefill_step


def make_decode_step(cfg):
    model = build_model(cfg)

    def serve_step(params, batch, cache, pos):
        return model.apply(params, batch, cache=cache, cache_pos=pos)

    return serve_step
