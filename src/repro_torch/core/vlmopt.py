"""VLMOpt (paper §5): three VRAM-side optimizations for VLM inference.

1. Vision tensor offload  — vision weights live in sysRAM, streamed at use.
2. Flash attention + Q-chunking in the vision encoder — the O(N^2) KQ score
   tensor never materialises; Q-chunking bounds the flash working set so
   arbitrary resolutions fit a target budget.
3. Vision/language overlap avoidance — vision encoding completes and frees
   its allocations before language init: peak = max(vision, language)
   instead of sum.

The analytic VRAM model is the reference's, copied (its integers equal the
reference's). The runnable ViT-style encoder runs its attention through K4
(``attend_flash``) with ``flash=True``, or fully materialised
(``attend_ref``) with ``flash=False``. Unlike the reference's, the flash
encoder runs every resolution: K4 masks a ragged last KV-chunk, so N need
not be a multiple of ``min(1024, N)``. Offload (1.) and the patch merger
are modelled analytically only, as in the reference.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device
from repro_torch.models.attention import attend_flash, attend_ref
from repro_torch.models.common import dense_init, rmsnorm


# ---------------------------------------------------------------- analytic
@dataclass(frozen=True)
class VisionConfig:
    d: int = 1280
    layers: int = 32
    heads: int = 16
    patch: int = 14
    merge: int = 2            # 2x2 patch merging after encoder
    dtype_bytes: int = 2


RESOLUTIONS = {"480p": (854, 480), "720p": (1280, 720),
               "1080p": (1920, 1080), "1440p": (2560, 1440)}


def n_vision_tokens(vc: VisionConfig, res: str) -> int:
    w, h = RESOLUTIONS[res]
    return (w // vc.patch) * (h // vc.patch)


def vision_weight_bytes(vc: VisionConfig) -> int:
    per_layer = 4 * vc.d * vc.d + 2 * vc.d * 4 * vc.d
    return vc.layers * per_layer * vc.dtype_bytes


def vision_vram_demand(vc: VisionConfig, res: str, *, offload: bool,
                       flash: bool, q_chunk: int = 1024) -> int:
    """Peak VRAM bytes of the vision encoder."""
    n = n_vision_tokens(vc, res)
    acts = 3 * n * vc.d * vc.dtype_bytes
    if flash:
        qc = min(q_chunk, n)
        attn_tmp = vc.heads * qc * min(n, 1024) * 4 + qc * vc.d * vc.dtype_bytes
    else:
        # full KQ scores in fp32 + probs: the paper's "several gigabytes"
        attn_tmp = 2 * vc.heads * n * n * 4
    weights = 0 if offload else vision_weight_bytes(vc)
    stream_buf = (2 * 4 * vc.d * vc.d * vc.dtype_bytes) if offload else 0
    return weights + acts + attn_tmp + stream_buf


def language_vram_demand(cfg, budget_like_bytes: int) -> int:
    """Language side demand is whatever pipelined sharding pins (<= budget)."""
    return budget_like_bytes


def vlm_peak_vram(vc: VisionConfig, res: str, lang_bytes: int, *,
                  vlmopt: bool, q_chunk: int = 1024) -> int:
    v = vision_vram_demand(vc, res, offload=vlmopt, flash=vlmopt,
                           q_chunk=q_chunk)
    if vlmopt:
        return max(v, lang_bytes)  # overlap avoidance
    return v + lang_bytes


def min_feasible_budget(vc: VisionConfig, res: str, lang_bytes: int, *,
                        vlmopt: bool) -> int:
    return vlm_peak_vram(vc, res, lang_bytes, vlmopt=vlmopt)


# ---------------------------------------------------------------- runnable
def init_vision_params(gen: torch.Generator, vc: VisionConfig,
                       dtype=torch.bfloat16):
    """Seeded random encoder weights drawn on ``gen``'s device, per-layer
    leaves stacked on a leading ``vc.layers`` axis (the reference's tree:
    ``ln1, ln2, wqkv, wo, w_up, w_down``)."""
    d, dev = vc.d, gen.device
    shapes = {"wqkv": (d, 3 * d), "wo": (d, d), "w_up": (d, 4 * d),
              "w_down": (4 * d, d)}
    p = {"ln1": torch.ones((vc.layers, d), dtype=dtype, device=dev),
         "ln2": torch.ones((vc.layers, d), dtype=dtype, device=dev)}
    for name, shape in shapes.items():
        p[name] = torch.empty((vc.layers,) + shape, dtype=dtype, device=dev)
    for i in range(vc.layers):
        for name, shape in shapes.items():
            p[name][i] = dense_init(gen, shape, 0, dtype)
    return p


def vision_encode(params, vc: VisionConfig, patches: torch.Tensor, *,
                  flash: bool, q_chunk: int = 1024, device=None):
    """patches: (B, N, d) precomputed patch embeddings -> (B, N, d).

    Bidirectional (non-causal) attention; the flash path runs K4 with a
    KV-chunk of ``min(1024, N)``. ``q_chunk`` is passed on as K4's
    ``block_q``: K4 tiles the query axis by its own fixed rows, so it needs
    none of the reference's search for a divisor of N and no value changes
    a result. Runs on the card unless ``device="cpu"``; the patches and the
    weights must already lie there."""
    device = resolve_device(device)
    for t in [patches] + list(params.values()):
        if t.device.type != device.type or device.index not in (
                None, t.device.index):
            raise ValueError(f"vision_encode runs on {device}; a tensor "
                             f"lies on {t.device}")
    hd = vc.d // vc.heads
    B, N, _ = patches.shape
    x = patches
    for i in range(vc.layers):
        lp = {k: v[i] for k, v in params.items()}
        h = rmsnorm(x, lp["ln1"], 1e-6)
        q, k, v = (t.reshape(B, N, vc.heads, hd)
                   for t in torch.chunk(h @ lp["wqkv"], 3, dim=-1))
        if flash:
            o = attend_flash(q, k, v, causal=False, q_chunk=q_chunk,
                             kv_chunk=min(1024, N))
        else:
            o = attend_ref(q, k, v, causal=False)
        x = x + o.reshape(B, N, vc.d) @ lp["wo"]
        h = rmsnorm(x, lp["ln2"], 1e-6)
        # the tanh approximation, as jax.nn.gelu's default
        x = x + F.gelu(h @ lp["w_up"], approximate="tanh") @ lp["w_down"]
    return x
