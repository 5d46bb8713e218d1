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
(``attend_plain``, ``attend_ref``'s computation) with ``flash=False``, and
stays within ``vision_vram_demand`` on the card in both: it overwrites its
patches with the residual stream and runs in row chunks. Unlike the
reference's, the flash encoder runs every resolution: K4 masks a ragged
last KV-chunk, so N need not be a multiple of ``min(1024, N)``. Offload
(1.) and the patch merger are modelled analytically only, as in the
reference.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device
from repro_torch.models.attention import attend_flash
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


def _row_chunks(n: int, rows: int):
    return [(r, min(r + rows, n)) for r in range(0, n, rows)]


def ffn_rows(n: int) -> int:
    """Rows of one FFN chunk: the room k and v held in attention, 2 N x d
    elements, over the 8 x d elements a row keeps live (its 4 d hidden and
    the gelu of it), so the FFN never holds more than the attention before
    it: N / 4, rounded up."""
    return max(1, -(-n // 4))


def attend_plain(q, k, v):
    """Bidirectional attention fully materialised, as ``attend_ref``
    computes it (bf16 scores rounded once, then f32, softmax, p in the
    input dtype, ``p @ v``), with the f32 scores and the probabilities in
    one buffer: the scale and the softmax are written in place, so the
    encoder's plain path holds one (B, KV, G, N, N) f32 tensor where the
    analytic model counts two. q: (B, N, H, hd); k, v: (B, N, KV, hd)."""
    B, T, H, hd = q.shape
    KV = k.shape[2]
    qg = q.reshape(B, T, KV, H // KV, hd)
    s = torch.einsum("btkgd,bskd->bkgts", qg, k)
    s32 = s.to(torch.float32)
    del s
    s32.mul_(hd ** -0.5)
    s32.sub_(s32.amax(dim=-1, keepdim=True))
    s32.exp_()
    s32.div_(s32.sum(dim=-1, keepdim=True))
    p = s32.to(v.dtype)
    del s32
    o = torch.einsum("bkgts,bskd->btkgd", p, v)
    return o.reshape(B, T, H, hd)


def vision_encode(params, vc: VisionConfig, patches: torch.Tensor, *,
                  flash: bool, q_chunk: int = 1024, device=None):
    """patches: (B, N, d) precomputed patch embeddings -> (B, N, d), the
    result written into ``patches`` itself, which is returned: the patch
    embeddings are the residual stream (a VLM pipeline hands them over as
    a temporary; a caller that needs them afterwards passes a clone).

    Bidirectional (non-causal) attention. The live activations are the
    residual and, in attention, k and v: the analytic model's three N x d
    activations. The flash path projects k and v in row chunks of
    ``q_chunk``, then runs each chunk of ``q_chunk`` queries (its rmsnorm
    computed again, as holding q or the normed rows for all N would take a
    fourth N x d) through one K4 launch against all keys, with a KV-chunk
    of ``min(1024, N)`` (K4 masks ragged chunks, so N need not be a
    multiple of either); chunk-sized temporaries live in the room of the
    model's score term. The plain path computes full q, k, v and
    ``attend_plain``'s materialised scores, the paper's baseline. On both,
    each FFN runs in chunks of ``ffn_rows(N)`` rows, in the room k and v
    held. Runs on the card unless ``device="cpu"``; the patches and the
    weights must already lie there."""
    device = resolve_device(device)
    for t in [patches] + list(params.values()):
        if t.device.type != device.type or device.index not in (
                None, t.device.index):
            raise ValueError(f"vision_encode runs on {device}; a tensor "
                             f"lies on {t.device}")
    d, H = vc.d, vc.heads
    hd = d // H
    B, N, _ = patches.shape
    rows = _row_chunks(N, q_chunk)
    x = patches
    for i in range(vc.layers):
        lp = {k: v[i] for k, v in params.items()}
        wqkv = lp["wqkv"]
        if flash:
            kv = torch.empty((B, N, 2 * d), dtype=x.dtype, device=x.device)
            for r0, r1 in rows:
                kv[:, r0:r1] = rmsnorm(x[:, r0:r1], lp["ln1"], 1e-6) \
                    @ wqkv[:, d:]
            k = kv[..., :d].reshape(B, N, H, hd)
            v = kv[..., d:].reshape(B, N, H, hd)
            for r0, r1 in rows:
                q = (rmsnorm(x[:, r0:r1], lp["ln1"], 1e-6) @ wqkv[:, :d]) \
                    .reshape(B, r1 - r0, H, hd)
                o = attend_flash(q, k, v, causal=False, q_chunk=q_chunk,
                                 kv_chunk=min(1024, N))
                del q
                x[:, r0:r1] += o.reshape(B, r1 - r0, d) @ lp["wo"]
                del o
            del kv, k, v
        else:
            q, k, v = (t.reshape(B, N, H, hd) for t in torch.chunk(
                rmsnorm(x, lp["ln1"], 1e-6) @ wqkv, 3, dim=-1))
            o = attend_plain(q, k, v)
            del q, k, v
            x += o.reshape(B, N, d) @ lp["wo"]
            del o
        for r0, r1 in _row_chunks(N, ffn_rows(N)):
            h = rmsnorm(x[:, r0:r1], lp["ln2"], 1e-6)
            u = h @ lp["w_up"]
            del h
            # the tanh approximation, as jax.nn.gelu's default
            g = F.gelu(u, approximate="tanh")
            del u
            x[:, r0:r1] += g @ lp["w_down"]
            del g
    return x
