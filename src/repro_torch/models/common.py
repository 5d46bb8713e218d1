"""Shared layer primitives: norms, positions (RoPE, M-RoPE, sinusoidal),
init, greedy pick, and the remat policies of a training forward."""
from __future__ import annotations

import numpy as np
import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.device import is_fake
from repro_torch.launch import counting

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}


def dtype_of(cfg) -> torch.dtype:
    return _DTYPES[cfg.dtype]


def tree_map(fn, tree):
    """Apply ``fn`` to every leaf of a nested dict of tensors."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def tree_leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    return [tree]


def tree_flatten(tree):
    """(leaves, treedef) in ``jax.tree_util``'s order: dict keys sorted,
    lists and tuples in order, ``None`` a node without leaves; anything
    else is a leaf. The order the checkpoint format and the optimizer's
    sums follow, so both packages walk a tree alike."""
    if isinstance(tree, dict):
        keys = sorted(tree)
        subs = [tree_flatten(tree[k]) for k in keys]
        return ([x for leaves, _ in subs for x in leaves],
                ("dict", keys, [d for _, d in subs]))
    if isinstance(tree, (list, tuple)):
        subs = [tree_flatten(t) for t in tree]
        return ([x for leaves, _ in subs for x in leaves],
                (type(tree), None, [d for _, d in subs]))
    if tree is None:
        return [], ("none", None, [])
    return [tree], ("leaf", None, [])


def tree_unflatten(treedef, leaves):
    """The tree ``treedef`` describes, with ``leaves`` in flatten order."""
    it = iter(leaves)

    def build(d):
        kind, keys, subs = d
        if kind == "leaf":
            return next(it)
        if kind == "none":
            return None
        if kind == "dict":
            return {k: build(s) for k, s in zip(keys, subs)}
        return kind(build(s) for s in subs)
    return build(treedef)


def treedef_str(treedef) -> str:
    """``treedef`` written as ``str`` of a JAX ``PyTreeDef``, e.g.
    ``PyTreeDef({'a': *, 'b': [*, None]})``."""
    def fmt(d):
        kind, keys, subs = d
        if kind == "leaf":
            return "*"
        if kind == "none":
            return "None"
        if kind == "dict":
            return "{" + ", ".join(f"{k!r}: {fmt(s)}"
                                   for k, s in zip(keys, subs)) + "}"
        inner = ", ".join(fmt(s) for s in subs)
        return f"[{inner}]" if kind is list else \
            f"({inner}{',' if len(subs) == 1 else ''})"
    return f"PyTreeDef({fmt(treedef)})"


def tree_nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def stacked(make, n):
    """``n`` trees from ``make()`` stacked along a new leading axis (the
    reference's per-layer layout), each leaf one allocation written as the
    trees are made."""
    out = None
    for i in range(n):
        t = make()
        if out is None:
            out = tree_map(lambda x: x.new_empty((n,) + tuple(x.shape)), t)
        _assign(out, t, i)
    return out


def _assign(stack, tree, i):
    for k, v in tree.items():
        if isinstance(v, dict):
            _assign(stack[k], v, i)
        else:
            stack[k][i] = v


# ---------------------------------------------------------------- sampling
def greedy_token(logits: torch.Tensor) -> torch.Tensor:
    """Deterministic greedy pick over a logits row (or batch of rows).

    Argmax over float32-upcast logits along the last axis, ties broken
    toward the lowest token index, as the reference's ``greedy_token``.
    bf16 logits tie often at small widths, so the upcast comes before the
    argmax (``torch.argmax`` returns the first maximal index)."""
    return torch.argmax(logits.to(torch.float32), dim=-1).to(torch.int32)


# ---------------------------------------------------------------- norms
def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    dt = x.dtype
    x = x.to(torch.float32)
    y = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (y * scale.to(torch.float32)).to(dt)


def layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              eps: float) -> torch.Tensor:
    dt = x.dtype
    x = x.to(torch.float32)
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean((x - mu) ** 2, dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * scale.to(torch.float32) + bias.to(torch.float32)).to(dt)


# ---------------------------------------------------------------- positions
def rope_freqs(head_dim: int, theta: float) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float32)
                            / head_dim))


def _cached(cache, key, fake, make):
    """``cache[key]``, made by ``make()`` on first use: a constant of the
    program, so inside a count it is neither counted nor tracked
    (``counting.constant``). For fake tensors (``fake``: a count's specs)
    it is made anew each time and never stored, so no fake tensor is left
    in ``cache`` for a later real run, or a later count, to read."""
    with counting.constant():
        if fake:
            return make()
        if key not in cache:
            cache[key] = make()
        return cache[key]


_FREQS = {}   # (head_dim, theta, device) -> the rope_freqs tensor


def _device_freqs(head_dim: int, theta: float, device: torch.device,
                  fake: bool = False) -> torch.Tensor:
    """``rope_freqs`` on ``device``, copied there once: a copy from
    pageable host memory blocks the host, and rope runs twice per
    attention step. ``fake``: for fake tensors (``_cached``)."""
    return _cached(_FREQS, (head_dim, theta, device), fake,
                   lambda: torch.from_numpy(rope_freqs(head_dim, theta))
                   .to(device))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., T, H, hd); positions: broadcastable to (..., T)."""
    hd = x.shape[-1]
    freqs = _device_freqs(hd, theta, x.device, is_fake(x))
    angles = positions[..., None].to(torch.float32) * freqs  # (..., T, hd/2)
    angles = angles[..., None, :]          # broadcast over heads
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


_MROPE_AXES = {}   # (half, sections, device) -> the slot -> axis tensor


def _mrope_axes(half: int, sections, device: torch.device,
                fake: bool = False) -> torch.Tensor:
    """Which position axis (t, h, w) drives each of the ``half`` frequency
    slots: ``sections`` scaled to ``half`` with floor, the last section
    taking the remainder, as the reference scales them. Copied to
    ``device`` once, as ``_device_freqs``."""
    def make():
        sec = np.array(sections, dtype=np.float64)
        sec = np.floor(sec / sec.sum() * half).astype(int)
        sec[-1] = half - sec[:-1].sum()
        axes = np.concatenate([np.full(s, i) for i, s in enumerate(sec)])
        return torch.from_numpy(axes).to(device)
    return _cached(_MROPE_AXES, (half, tuple(sections), device), fake, make)


def apply_mrope(x: torch.Tensor, positions_3d: torch.Tensor, theta: float,
                sections=(16, 24, 24)) -> torch.Tensor:
    """Qwen2-VL M-RoPE. x: (..., T, H, hd); positions_3d: (3, ..., T) for
    the (t, h, w) axes. The hd/2 frequency slots are split across the three
    axes by ``sections`` (scaled to hd/2); the angles are f32."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = _device_freqs(hd, theta, x.device, is_fake(x))
    axis_id = _mrope_axes(half, sections, x.device, is_fake(x))
    pos = torch.movedim(positions_3d, 0, -1)[..., axis_id]  # (..., T, half)
    angles = (pos.to(torch.float32) * freqs)[..., None, :]
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


_SIN_FREQS = {}   # (half, device) -> the sinusoidal frequencies


def sinusoidal_positions(positions: torch.Tensor,
                         d_model: int) -> torch.Tensor:
    """AudioCraft-style sin/cos embeddings, (..., T) -> (..., T, d) in f32.
    The frequencies are the reference's f32 ``exp(-log(10000) * i /
    half)``, computed in that order on the positions' device, once (as
    ``_device_freqs``: a decode step adds them)."""
    half = d_model // 2
    dev = positions.device

    def make():
        i = torch.arange(half, dtype=torch.float32, device=dev)
        return torch.exp(torch.tensor(-np.log(10000.0), dtype=torch.float32,
                                      device=dev) * i / half)
    freqs = _cached(_SIN_FREQS, (half, dev), is_fake(positions), make)
    ang = positions[..., None].to(torch.float32) * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# ---------------------------------------------------------------- init
def dense_init(gen: torch.Generator, shape, in_axis=0,
               dtype=torch.bfloat16) -> torch.Tensor:
    """Normal(0, 1/fan_in) weights drawn on the generator's device and
    cast to ``dtype``."""
    fan_in = shape[in_axis] if isinstance(in_axis, int) else int(
        np.prod([shape[a] for a in in_axis]))
    std = 1.0 / np.sqrt(fan_in)
    w = torch.randn(tuple(shape), generator=gen, dtype=torch.float32,
                    device=gen.device)
    return (w * std).to(dtype)


# ---------------------------------------------------------------- remat
REMAT = ("none", "full", "dots")
_SAVED_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):  # noqa: ARG001
    """Save the outputs of 2-D products and recompute everything else:
    the counterpart of ``dots_with_no_batch_dims_saveable`` (a product
    with a batch dim, ``bmm`` and the einsums, is recomputed)."""
    return CheckpointPolicy.MUST_SAVE if op in _SAVED_DOTS \
        else CheckpointPolicy.PREFER_RECOMPUTE


def _dots_context():
    return create_selective_checkpoint_contexts(_dots_policy)


def remat_call(fn, remat, *args):
    """``fn(*args)`` (one layer, group or pair) under the reference's remat
    policy: ``"full"`` recomputes it in the backward
    (``nothing_saveable``), ``"dots"`` keeps its 2-D products' outputs
    (``_dots_policy``), ``"none"`` saves what autograd saves. Without grad
    mode (serving) every policy is the plain call."""
    if remat not in REMAT:
        raise ValueError(f"remat={remat!r} not in {REMAT}")
    if remat == "none" or not torch.is_grad_enabled():
        return fn(*args)
    if remat == "full":
        return checkpoint(fn, *args, use_reentrant=False)
    return checkpoint(fn, *args, use_reentrant=False,
                      context_fn=_dots_context)
