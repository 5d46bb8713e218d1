"""Seeded weights, drawn on the card in a few large calls and kept in
pinned host memory, in the layout the port's ``Session`` takes
(``params=``). The architecture's file (``arch/<model_type>.py``) lists
the leaves: their paths, shapes, served types and scales.

A matrix is N(0, std^2) at the std its leaf lists (1/sqrt(fan_in)); a
norm scale is 1 + N(0, 0.05^2), so a path that skipped a norm's scale
would show. Everything is drawn in f32 on the generator's
device, scaled and cast to the leaf's type.
"""
from __future__ import annotations

import torch

CHUNK_ELEMS = 1 << 29      # f32 elements drawn per call: 2 GiB


def _put(tree, path, value):
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def draw_weights(leaves, seed: int, device) -> dict:
    """The host weight tree of ``leaves`` (``(path, shape, dtype, std or
    None for a norm scale)`` in drawing order) from ``seed``: drawn on
    ``device`` (the card, or the CPU in tests), pinned on the host when
    ``device`` is a card."""
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(abs(int(seed)))
    pin = device.type == "cuda"
    tree = {}
    for path, shape, dtype, std in leaves:
        host = torch.empty(shape, dtype=dtype, pin_memory=pin)
        flat = host.view(-1)
        n = flat.numel()
        for a in range(0, n, CHUNK_ELEMS):
            b = min(n, a + CHUNK_ELEMS)
            x = torch.randn((b - a,), generator=gen, dtype=torch.float32,
                            device=device)
            if std is None:
                x.mul_(0.05).add_(1.0)
            else:
                x.mul_(std)
            flat[a:b].copy_(x.to(dtype), non_blocking=pin)
            del x
        _put(tree, path, host)
    if pin:
        torch.cuda.synchronize(device)
    return tree
