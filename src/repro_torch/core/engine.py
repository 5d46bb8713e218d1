"""Sub-layer engine: the step functions the executor runs, dense stacked KV.

Each step is a plain function of the config, the sub-layer's weights (a
dict of tensors, as the reference passes trees) and the activations. PyTorch
runs them eagerly, with no ``torch.compile``: there is no counterpart of the
reference's ``jax.jit`` executable cache. The one replay is the executor's:
a fused decode pass whose sub-layers are all pinned is recorded once per
key and replayed, the same kernels in the same order
(``PipelinedExecutor.decode_fused``); ``ExecStats.decode_graph_captures``
is the counterpart of ``trace_counts``. The streamed matmuls stay out of
its CUDA graphs: ``_mm`` launches them through ``cudagraph.eager``, on
every replay too.

KV caches are stacked ``(n_layers, B, KV, S, hd)`` tensors, or a paged
cache's page pools ``(P, KV, page_size, hd)`` with a per-layer page table
(``core/kvpaged.py``). The attention steps write this layer's rows or
pages in place — where the reference donated the stacks and pools to its
jitted steps so XLA could update them in place — and return only the
residual output. ``layer``, ``slot``, ``pos`` and ``valid_len`` are host
integers; a decode step's per-slot positions and active mask, and a page
table, are tensors on the device.

A speculative verify pass runs the FFN, MoE and head of a (B, W) window
whose columns must come out bit-equal to W decode steps of (B, 1). The
matmuls of the FFN and the experts are K1–K3, whose rows do not depend on
M; the norms are reductions, whose launch configuration PyTorch picks from
the output count, so with ``cols=True`` a step takes each column's norm at
the decode step's own shape (``_norm``). The executor runs the head per
column.

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

from repro_torch.core import cudagraph
from repro_torch.models import attention as attn_mod
from repro_torch.models import mlp as mlp_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.common import rmsnorm
from repro_torch.models.mlp import _mm_dispatch, activate


def _positions(B, T, pos, device):
    return (pos + torch.arange(T, device=device))[None, :].expand(B, T)


def column(x, j):
    """Column ``j`` of x (B, T, d) as a fresh contiguous (B, 1, d) tensor,
    exactly as a decode step holds its residual (a reduction's launch
    configuration, and so its order of sums, can follow the strides and
    the alignment of its input)."""
    return x[:, j:j + 1].clone(memory_format=torch.contiguous_format)


def _norm(x, scale, eps, cols=False):
    """``rmsnorm(x)``; with ``cols``, each ``column`` on its own, so a
    verify window's norms equal the decode steps'."""
    if not cols or x.shape[1] == 1:
        return rmsnorm(x, scale, eps)
    return torch.cat([rmsnorm(column(x, j), scale, eps)
                      for j in range(x.shape[1])], dim=1)


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


def rollback_step(kstack, vstack, zero_from, active):
    """Zero KV at positions >= ``zero_from[b]`` on active rows, every layer
    at once, in place: the stacked rejected-suffix rollback of a verify
    pass. The stacked cache starts at zero and is append-only, so "never
    written" is "all zeros", and the masked zero-write leaves the cache
    byte-equal to a run that never verified the rejected drafts. Rows whose
    suffix was already clean rewrite zeros with zeros."""
    S = kstack.shape[3]
    clear = (torch.arange(S, device=kstack.device)[None, :]
             >= zero_from[:, None]) & active[:, None]
    mask = clear[None, :, None, :, None]
    kstack.masked_fill_(mask, 0)
    vstack.masked_fill_(mask, 0)


# ------------------------------------------------------------ paged kv
# The paged cache stores KV in physical pages (P, KV, page_size, hd); a
# per-layer table (B, n_blocks) maps each slot's logical blocks to pages.
# Writes scatter through the table (masked positions go to page 0, the
# null sink, so no conditional is needed); reads gather ``pool[table]``
# into the exact (B, KV, S, hd) stacked view, after which the attention
# math is the stacked steps'. Unwritten page slots, and the sink's garbage,
# sit at masked positions whose softmax weight is exactly 0.0, so the paged
# steps equal the stacked ones bit for bit. The scatters index two
# advanced dims around a slice; as in NumPy, the broadcast index dims come
# first, so ``pool[pid, :, off]`` is (B, KV, hd) for pid and off (B,).
# Several rows may write the sink at one (page, offset): which one lands is
# not fixed on CUDA, and nothing reads it unmasked (never accumulate).
def _pool_view(pool, table):
    """Gather (P, KV, ps, hd) pages into a (B, KV, n_blocks*ps, hd)
    stacked-cache view through the page table (B, n_blocks)."""
    B, nblk = table.shape
    g = pool[table].permute(0, 2, 1, 3, 4)
    return g.reshape(B, g.shape[1], nblk * pool.shape[2], g.shape[4])


def attn_decode_paged_step(cfg, w, x, k_pool, v_pool, table, pos_vec,
                           active):
    """Fused multi-slot decode against the page pool. x: (B, 1, d);
    table: (B, n_blocks) physical pages of this layer; pos_vec / active as
    in ``attn_decode_step``. The new token's k/v scatter into page
    ``table[b, pos_b // ps]`` at offset ``pos_b % ps`` (inactive slots
    write the null page), then the gathered view feeds ``attend_decode``."""
    B = x.shape[0]
    ps = k_pool.shape[2]
    h = rmsnorm(x, w["ln1"], cfg.norm_eps)
    q, k, v = attn_mod.qkv_project(w["attn"], cfg, h, pos_vec[:, None])
    pos = pos_vec.to(torch.int64)
    pid = table[torch.arange(B, device=x.device), pos // ps]
    pid = torch.where(active, pid, 0)
    off = pos % ps
    k_pool[pid, :, off] = k[:, 0].to(k_pool.dtype)
    v_pool[pid, :, off] = v[:, 0].to(v_pool.dtype)
    o = attn_mod.attend_decode(q, _pool_view(k_pool, table),
                               _pool_view(v_pool, table), pos_vec)
    return x + attn_mod.out_project(o.reshape(B, 1, -1), w["attn"]["wo"])


def attn_prefill_paged_step(cfg, w, x, k_pool, v_pool, table, pos: int,
                            valid_len: int):
    """Layer-major prefill chunk against the page pool. x: (B, T, d) at
    absolute positions pos..pos+T-1; padded-tail positions (>= valid_len)
    scatter to the null page — the paged form of the stacked step's
    masked cache write."""
    B, T, _ = x.shape
    ps = k_pool.shape[2]
    h = rmsnorm(x, w["ln1"], cfg.norm_eps)
    q, k, v = attn_mod.qkv_project(w["attn"], cfg, h,
                                   _positions(B, T, pos, x.device))
    tpos = pos + torch.arange(T, device=x.device)
    valid = torch.arange(T, device=x.device) < valid_len
    pid = torch.where(valid[None, :], table[:, tpos // ps], 0)
    off = (tpos % ps)[None, :].expand(B, T)
    k_pool[pid, :, off] = k.to(k_pool.dtype)
    v_pool[pid, :, off] = v.to(v_pool.dtype)
    o = attn_mod.attend_cached(q, _pool_view(k_pool, table),
                               _pool_view(v_pool, table), pos)
    return x + attn_mod.out_project(o.reshape(B, T, -1), w["attn"]["wo"])


# ------------------------------------------------------------ ffn
def ffn_step(cfg, w, x, cols=False):
    """x + ffn(rmsnorm(x)), every matmul through K1, K2 or K3. ``cols``:
    the norm per column (a verify window, ``_norm``)."""
    return x + _ffn_streamed(cfg, w["ffn"], _norm(x, w["ln2"],
                                                  cfg.norm_eps, cols))


def _mm(x2, p, name):
    """``_mm_dispatch`` (K1, K2 or K3 by the weight's format: (M, N) in
    x2's dtype), launched outside any CUDA graph being recorded
    (``cudagraph.eager``)."""
    return cudagraph.eager(_mm_dispatch, (x2, p, name),
                           (x2.shape[0], p[name].shape[-1]), x2.dtype)


def _ffn_streamed(cfg, p, h):
    """Dense FFN with all matmuls through ``_mm``."""
    B, T, d = h.shape
    x2 = h.reshape(B * T, d)
    if cfg.mlp == "swiglu":
        hh = activate(cfg, _mm(x2, p, "w_gate"), _mm(x2, p, "w_up"))
    else:
        hh = activate(cfg, None, _mm(x2, p, "w_up"))
    return _mm(hh, p, "w_down").reshape(B, T, d)


# ------------------------------------------------------------ mamba
def mamba_step(cfg, w, x, conv, ssm_state, valid_len=None, active=None):
    """A Mamba-2 mixer layer of a patterned hybrid: x + mixer(rmsnorm(x)),
    its in- and out-projections through K1 (``_mm``).
    w: {"mamba": the layer's leaves, "ln"}; x: (B, T, d); conv (B, K-1, C)
    and ssm_state (B, H, P, N): this layer's state rows, read, then
    written in place. A prefill chunk's positions at or past
    ``valid_len`` (a padded tail) leave the state as it was
    (``ssm.mamba_mix``); a decode step's rows whose ``active`` is False
    keep theirs."""
    B, T, d = x.shape
    p = w["mamba"]
    di, h = cfg.d_inner, cfg.n_ssm_heads
    h2 = rmsnorm(x, w["ln"], cfg.norm_eps).reshape(B * T, d)
    zxd = _mm(h2, p, "w_in").reshape(B, T, -1)
    z, xbc, dt_raw = torch.split(zxd, [di, zxd.shape[-1] - di - h, h],
                                 dim=-1)
    y, new = ssm_mod.mamba_mix(p, cfg, z, xbc, ssm_mod.mamba_dt(p, dt_raw),
                               {"conv": conv, "ssm": ssm_state}, valid_len)
    for old, upd in ((conv, new["conv"]), (ssm_state, new["ssm"])):
        if active is not None:
            keep = active.reshape((B,) + (1,) * (old.ndim - 1))
            upd = torch.where(keep, upd.to(old.dtype), old)
        old.copy_(upd)
    out = _mm(y.reshape(B * T, di), p, "w_out")
    return x + out.reshape(B, T, d)


# ------------------------------------------------------------ moe
def _valid_mask(B, T, valid_len, device):
    return (torch.arange(T, device=device)[None, :] < valid_len) \
        .expand(B, T)


def moe_step(cfg, w, x, cols=False):
    """The monolithic MoE sub-layer: x + moe_ffn(rmsnorm(x)).
    w: {"moe": the layer's MoE tree (split per expert), "ln2"}."""
    return x + mlp_mod.moe_ffn(w["moe"], cfg,
                               _norm(x, w["ln2"], cfg.norm_eps, cols))


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
def _route_dispatch(cfg, w, x, valid=None, cols=False):
    m = cfg.moe
    B, T, d = x.shape
    h = _norm(x, w["ln2"], cfg.norm_eps, cols).reshape(B * T, d)
    gates, idx, _ = mlp_mod._route(h, w["router"], m)
    if valid is not None:
        idx = torch.where(valid.reshape(B * T)[:, None], idx, m.n_experts)
    disp, aux = mlp_mod.moe_dispatch(h, gates, idx, m, m.n_experts, 0,
                                     mlp_mod.capacity_of(B * T, m))
    return disp, aux, idx


def moe_route_step(cfg, w, x, cols=False):
    """w: {"router", "ln2"}; x: (B, T, d). Returns (disp, aux, idx)."""
    return _route_dispatch(cfg, w, x, cols=cols)


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
