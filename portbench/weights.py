"""Seeded weights, drawn on the card in a few large calls and kept in
pinned host memory, in the stacked layout the port's ``Session`` takes
(``params=``): each per-layer leaf has a leading layer axis.

Matrices are N(0, 1/fan_in); norm scales are 1 + N(0, 0.05^2), so a
path that skipped a norm's scale would show. Everything is drawn in f32
on the generator's device, scaled and cast to the served type (bf16; the
MoE router in f32, as the port serves it).
"""
from __future__ import annotations

import math

import torch

from .shapes import Shapes

CHUNK_ELEMS = 1 << 29      # f32 elements drawn per call: 2 GiB


def _leaves(s: Shapes):
    """(path, shape, dtype, std or None for a norm scale)."""
    L, d, hd = s.n_layers, s.d, s.head_dim
    bf, f32 = getattr(torch, s.dtype), torch.float32
    out = [(("embed",), (s.vocab, d), bf, 1 / math.sqrt(d)),
           (("final_norm",), (d,), bf, None),
           (("layers", "ln1"), (L, d), bf, None),
           (("layers", "ln2"), (L, d), bf, None),
           (("layers", "attn", "wq"), (L, d, s.n_heads * hd), bf,
            1 / math.sqrt(d)),
           (("layers", "attn", "wk"), (L, d, s.n_kv * hd), bf,
            1 / math.sqrt(d)),
           (("layers", "attn", "wv"), (L, d, s.n_kv * hd), bf,
            1 / math.sqrt(d)),
           (("layers", "attn", "wo"), (L, s.n_heads * hd, d), bf,
            1 / math.sqrt(s.n_heads * hd))]
    if s.qk_norm:
        out += [(("layers", "attn", "q_norm"), (L, hd), bf, None),
                (("layers", "attn", "k_norm"), (L, hd), bf, None)]
    if not s.tie:
        out.append((("unembed",), (d, s.vocab), bf, 1 / math.sqrt(d)))
    if s.moe:
        E, f = s.n_experts, s.d_ff
        out += [(("layers", "moe", "router"), (L, d, E), f32,
                 1 / math.sqrt(d)),
                (("layers", "moe", "w_gate"), (L, E, d, f), bf,
                 1 / math.sqrt(d)),
                (("layers", "moe", "w_up"), (L, E, d, f), bf,
                 1 / math.sqrt(d)),
                (("layers", "moe", "w_down"), (L, E, f, d), bf,
                 1 / math.sqrt(f))]
    else:
        f = s.d_ff
        out += [(("layers", "ffn", "w_gate"), (L, d, f), bf,
                 1 / math.sqrt(d)),
                (("layers", "ffn", "w_up"), (L, d, f), bf, 1 / math.sqrt(d)),
                (("layers", "ffn", "w_down"), (L, f, d), bf,
                 1 / math.sqrt(f))]
    return out


def _put(tree, path, value):
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def draw_weights(s: Shapes, seed: int, device) -> dict:
    """The host weight tree for ``s`` from ``seed``: drawn on ``device``
    (the card, or the CPU in tests), pinned on the host when ``device``
    is a card."""
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(abs(int(seed)))
    pin = device.type == "cuda"
    tree = {}
    for path, shape, dtype, std in _leaves(s):
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
