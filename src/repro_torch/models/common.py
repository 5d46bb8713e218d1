"""Shared layer primitives: norms, rotary positions (RoPE, M-RoPE), init,
greedy pick."""
from __future__ import annotations

import numpy as np
import torch

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


def tree_nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


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


# ---------------------------------------------------------------- positions
def rope_freqs(head_dim: int, theta: float) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float32)
                            / head_dim))


_FREQS = {}   # (head_dim, theta, device) -> the rope_freqs tensor


def _device_freqs(head_dim: int, theta: float,
                  device: torch.device) -> torch.Tensor:
    """``rope_freqs`` on ``device``, copied there once: a copy from
    pageable host memory blocks the host, and rope runs twice per
    attention step."""
    key = (head_dim, theta, device)
    if key not in _FREQS:
        _FREQS[key] = torch.from_numpy(rope_freqs(head_dim, theta)).to(device)
    return _FREQS[key]


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., T, H, hd); positions: broadcastable to (..., T)."""
    hd = x.shape[-1]
    freqs = _device_freqs(hd, theta, x.device)
    angles = positions[..., None].to(torch.float32) * freqs  # (..., T, hd/2)
    angles = angles[..., None, :]          # broadcast over heads
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


_MROPE_AXES = {}   # (half, sections, device) -> the slot -> axis tensor


def _mrope_axes(half: int, sections, device: torch.device) -> torch.Tensor:
    """Which position axis (t, h, w) drives each of the ``half`` frequency
    slots: ``sections`` scaled to ``half`` with floor, the last section
    taking the remainder, as the reference scales them. Copied to
    ``device`` once, as ``_device_freqs``."""
    key = (half, tuple(sections), device)
    if key not in _MROPE_AXES:
        sec = np.array(sections, dtype=np.float64)
        sec = np.floor(sec / sec.sum() * half).astype(int)
        sec[-1] = half - sec[:-1].sum()
        axes = np.concatenate([np.full(s, i) for i, s in enumerate(sec)])
        _MROPE_AXES[key] = torch.from_numpy(axes).to(device)
    return _MROPE_AXES[key]


def apply_mrope(x: torch.Tensor, positions_3d: torch.Tensor, theta: float,
                sections=(16, 24, 24)) -> torch.Tensor:
    """Qwen2-VL M-RoPE. x: (..., T, H, hd); positions_3d: (3, ..., T) for
    the (t, h, w) axes. The hd/2 frequency slots are split across the three
    axes by ``sections`` (scaled to hd/2); the angles are f32."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = _device_freqs(hd, theta, x.device)
    axis_id = _mrope_axes(half, sections, x.device)
    pos = torch.movedim(positions_3d, 0, -1)[..., axis_id]  # (..., T, half)
    angles = (pos.to(torch.float32) * freqs)[..., None, :]
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


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
