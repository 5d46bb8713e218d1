"""Sub-layer engine: the step functions the executor runs, dense stacked KV.

Each step is a plain function of the config, the sub-layer's weights (a
dict of tensors, as the reference passes trees) and the activations. PyTorch
runs them eagerly: there is no counterpart of the reference's ``jax.jit``
executable cache and so none of its ``trace_counts`` (the port uses neither
CUDA graphs nor ``torch.compile``).

KV caches are stacked ``(n_layers, B, KV, S, hd)`` tensors. The attention
steps write this layer's rows in place — where the reference donated the
stacks to its jitted steps so XLA could update them in place — and return
only the residual output. ``layer``, ``slot``, ``pos`` and ``valid_len`` are
host integers; a decode step's per-slot positions and active mask are
tensors on the device.

Every dense FFN and MoE expert matmul goes through the streamed matmul of
its weight's format (``models.mlp._mm_dispatch``): K1 for bf16/f32
weights, K2 for grouped or per-expert int8, K3 for packed int4
(``kernels.streamed_matmul``), pinned and streamed placements alike; the
MoE router's f32 logits go through K1 in f32. On the card each is a
hand-written kernel for any shape and any quantisation grouping (they
mask ragged tiles and take ragged groups, so the reference's
divisibility and ragged-group vetoes do not carry over), on the CPU its
plain version. One kernel for every placement
keeps the tokens identical across budgets: a placement change never
changes the order of a sum. The served path never dequantises a weight
outside the kernels.
"""
from __future__ import annotations

import torch

from repro_torch.models import attention as attn_mod
from repro_torch.models import mlp as mlp_mod
from repro_torch.models.common import rmsnorm
from repro_torch.models.mlp import _mm_dispatch, activate


def _positions(B, T, pos, device):
    return (pos + torch.arange(T, device=device))[None, :].expand(B, T)


# ------------------------------------------------------------ attn
def attn_step(cfg, w, x, kstack, vstack, layer: int, pos: int):
    """x: (B,T,d); kstack/vstack: (L,B,KV,S,hd). Returns x + attn(x); this
    layer's cache rows are written in place."""
    B, T, _ = x.shape
    h = rmsnorm(x, w["ln1"], cfg.norm_eps)
    out, _ = attn_mod.attention_block(
        w["attn"], cfg, h, _positions(B, T, pos, x.device),
        cache={"k": kstack[layer], "v": vstack[layer]}, cache_pos=pos)
    return x + out


def _prefill_attn_math(cfg, w, x, ck, cv, pos: int, valid_len: int):
    """The cache-slice-independent core of a prefill attention step, shared
    by the layer-indexed and the slot-threaded variants so they agree bit
    for bit. Positions at or past ``pos + valid_len`` (a padded tail) are
    kept out of the cache; causality already keeps valid queries away from
    them. Returns the attention output."""
    B, T, _ = x.shape
    h = rmsnorm(x, w["ln1"], cfg.norm_eps)
    q, k, v = attn_mod.qkv_project(w["attn"], cfg, h,
                                   _positions(B, T, pos, x.device))
    attn_mod.cache_update(ck, cv, k, v, pos, valid_end=pos + valid_len)
    o = attn_mod.attend_cached(q, ck, cv, pos)
    return attn_mod.out_project(o.reshape(B, T, -1), w["attn"]["wo"])


def attn_prefill_step(cfg, w, x, kstack, vstack, layer: int, pos: int,
                      valid_len: int):
    """Layer-major prefill attention: ``attn_step`` plus the masked cache
    write of a padded tail chunk."""
    return x + _prefill_attn_math(cfg, w, x, kstack[layer], vstack[layer],
                                  pos, valid_len)


def attn_prefill_slot_step(cfg, w, x, kstack, vstack, layer: int, slot: int,
                           pos: int, valid_len: int):
    """Slot-threaded layer-major prefill: x is (1, T, d), ONE admitted
    sequence, written into row ``slot`` of the shared stacked cache."""
    return x + _prefill_attn_math(cfg, w, x,
                                  kstack[layer, slot:slot + 1],
                                  vstack[layer, slot:slot + 1],
                                  pos, valid_len)


def attn_decode_step(cfg, w, x, kstack, vstack, layer: int, pos_vec, active):
    """Fused multi-slot decode attention. x: (B, 1, d), one new token per
    slot; pos_vec: (B,) int per-slot cache position; active: (B,) bool.
    Inactive slots' caches stay untouched."""
    B = x.shape[0]
    h = rmsnorm(x, w["ln1"], cfg.norm_eps)
    ck, cv = kstack[layer], vstack[layer]
    q, k, v = attn_mod.qkv_project(w["attn"], cfg, h, pos_vec[:, None])
    attn_mod.cache_update_batched(ck, cv, k, v, pos_vec, active=active)
    o = attn_mod.attend_decode(q, ck, cv, pos_vec)
    return x + attn_mod.out_project(o.reshape(B, 1, -1), w["attn"]["wo"])


# ------------------------------------------------------------ ffn
def ffn_step(cfg, w, x):
    """x + ffn(rmsnorm(x)), every matmul through K1, K2 or K3."""
    return x + _ffn_streamed(cfg, w["ffn"], rmsnorm(x, w["ln2"],
                                                    cfg.norm_eps))


def _ffn_streamed(cfg, p, h):
    """Dense FFN with all matmuls through ``_mm_dispatch``."""
    B, T, d = h.shape
    x2 = h.reshape(B * T, d)
    if cfg.mlp == "swiglu":
        hh = activate(cfg, _mm_dispatch(x2, p, "w_gate"),
                      _mm_dispatch(x2, p, "w_up"))
    else:
        hh = activate(cfg, None, _mm_dispatch(x2, p, "w_up"))
    return _mm_dispatch(hh, p, "w_down").reshape(B, T, d)


# ------------------------------------------------------------ moe
def _valid_mask(B, T, valid_len, device):
    return (torch.arange(T, device=device)[None, :] < valid_len) \
        .expand(B, T)


def moe_step(cfg, w, x):
    """The monolithic MoE sub-layer: x + moe_ffn(rmsnorm(x)).
    w: {"moe": the layer's MoE tree (split per expert), "ln2"}."""
    return x + mlp_mod.moe_ffn(w["moe"], cfg,
                               rmsnorm(x, w["ln2"], cfg.norm_eps))


def moe_prefill_step(cfg, w, x, valid_len: int):
    """Monolithic MoE for a layer-major prefill chunk: positions at or
    past ``valid_len`` (a padded tail) route to no expert, so a padded
    chunk equals the unpadded one on its valid positions."""
    B, T, _ = x.shape
    valid = _valid_mask(B, T, valid_len, x.device)
    return x + mlp_mod.moe_ffn(w["moe"], cfg,
                               rmsnorm(x, w["ln2"], cfg.norm_eps),
                               valid=valid)


# Expert-granular MoE: ``moe_step`` in three phases, so the executor can
# demand-stream the cold experts the router selected:
#   route   -> top-k and the capacity dispatch; the executor reads the
#              selected expert ids on the host and requests only those;
#   experts -> ``expert_ffn`` for some of the routed experts, written into
#              the layer's (E, C, d) output buffer; called for the pinned
#              experts while the cold ones copy, then once per cold expert
#              between its acquire and its release;
#   combine -> the gather, gate and k-ordered sum of ``moe_combine``.
# Each op is ``moe_ffn``'s, and each expert's rows depend only on its own
# weights, so the phased sub-layer equals the monolithic one bit for bit.
# The reference's ``fold_expert_step`` (one executable for folding a
# staged expert into a zero-filled stack) has no counterpart: no stack is
# built, an expert computes from the tree it was staged in.
def _route_dispatch(cfg, w, x, valid=None):
    m = cfg.moe
    B, T, d = x.shape
    h = rmsnorm(x, w["ln2"], cfg.norm_eps).reshape(B * T, d)
    gates, idx, _ = mlp_mod._route(h, w["router"], m)
    if valid is not None:
        idx = torch.where(valid.reshape(B * T)[:, None], idx, m.n_experts)
    disp, aux = mlp_mod.moe_dispatch(h, gates, idx, m, m.n_experts, 0,
                                     mlp_mod.capacity_of(B * T, m))
    return disp, aux, idx


def moe_route_step(cfg, w, x):
    """w: {"router", "ln2"}; x: (B, T, d). Returns (disp, aux, idx)."""
    return _route_dispatch(cfg, w, x)


def moe_route_prefill_step(cfg, w, x, valid_len: int):
    """``moe_route_step`` for a layer-major prefill chunk: positions at or
    past ``valid_len`` route to expert id E, out of range, so they claim
    no capacity and never enter the demanded set."""
    B, T, _ = x.shape
    return _route_dispatch(cfg, w, x,
                           valid=_valid_mask(B, T, valid_len, x.device))


def moe_experts_step(experts, disp, out_buf):
    """``expert_ffn`` for each ``(e, tree)`` of ``experts`` into
    ``out_buf[e]``."""
    mlp_mod.moe_experts(experts, disp, out_buf)


def moe_combine_step(x, out_buf, aux):
    B, T, d = x.shape
    return x + mlp_mod.moe_combine(out_buf, aux, B * T, x.dtype) \
        .reshape(B, T, d)


# ------------------------------------------------------------ ends
def embed_step(embed, tokens):
    return embed[tokens.to(torch.int64)]


def head_step(cfg, final_norm, unembed, x):
    """unembed: (d, V) — callers pass embed.T for tied embeddings."""
    return rmsnorm(x, final_norm, cfg.norm_eps) @ unembed
