"""GQA/MHA attention: projection, reference, flash (K4), cached-chunk and
decode paths.

Layout conventions (the reference's, so the tests compare like with like):
  activations  (B, T, D)
  q            (B, T, H, hd)
  k, v         (B, T, KV, hd)
  KV cache     (B, KV, S, hd)

Cache writes update the caller's cache tensors in place and return them:
the reference returns new arrays from ``dynamic_update_slice`` and relies on
buffer donation to make that in place. Like ``dynamic_update_slice``, a
write whose window would run past the end of the cache has its start
clamped so the whole update fits.

Without a cache, ``attend`` switches from the fully materialised
``attend_ref`` to ``attend_flash`` (K4, ``kernels/flash_attention.py``)
above ``FLASH_THRESHOLD`` tokens, as the reference does, so the
(B, KV, G, T, T) f32 scores never lie in device memory at long prompts.
The reference's ``REPRO_FORCE_REF_ATTN`` switch is a probe hook for XLA's
cost analysis of a scan-free graph; the port has no such lowering and no
counterpart to it.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.ops import flash_attention_bthd
from repro_torch.models.common import (apply_mrope, apply_rope, dense_init,
                                       rmsnorm)

FLASH_THRESHOLD = 2048
Q_CHUNK = 1024
KV_CHUNK = 1024
NEG_INF = -1e30


# ---------------------------------------------------------------- params
def init_attn_params(gen, cfg, dtype):
    d, hd = cfg.d_model, cfg.resolved_head_dim
    H, KV = cfg.n_heads, cfg.n_kv_heads
    p = {
        "wq": dense_init(gen, (d, H * hd), 0, dtype),
        "wk": dense_init(gen, (d, KV * hd), 0, dtype),
        "wv": dense_init(gen, (d, KV * hd), 0, dtype),
        "wo": dense_init(gen, (H * hd, d), 0, dtype),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((H * hd,), dtype=dtype, device=gen.device)
        p["bk"] = torch.zeros((KV * hd,), dtype=dtype, device=gen.device)
        p["bv"] = torch.zeros((KV * hd,), dtype=dtype, device=gen.device)
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((hd,), dtype=dtype, device=gen.device)
        p["k_norm"] = torch.ones((hd,), dtype=dtype, device=gen.device)
    return p


def qkv_project(params, cfg, x, positions):
    """x: (B, T, D) -> q (B,T,H,hd), k,v (B,T,KV,hd) with rope applied.
    positions: (B, T), or (3, B, T) for M-RoPE. ``"sin"`` positions are
    added at the embedding and ``"none"`` has none, so both leave q and k
    as projected."""
    if cfg.pos not in ("rope", "mrope", "sin", "none"):
        raise ValueError(f"unknown pos={cfg.pos!r}")
    B, T, _ = x.shape
    hd = cfg.resolved_head_dim
    q = x @ params["wq"]
    k = x @ params["wk"]
    v = x @ params["wv"]
    if cfg.qkv_bias:
        q, k, v = q + params["bq"], k + params["bk"], v + params["bv"]
    q = q.reshape(B, T, cfg.n_heads, hd)
    k = k.reshape(B, T, cfg.n_kv_heads, hd)
    v = v.reshape(B, T, cfg.n_kv_heads, hd)
    if cfg.qk_norm:
        q = rmsnorm(q, params["q_norm"], cfg.norm_eps)
        k = rmsnorm(k, params["k_norm"], cfg.norm_eps)
    if cfg.pos == "rope":
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    elif cfg.pos == "mrope":
        q = apply_mrope(q, positions, cfg.rope_theta)
        k = apply_mrope(k, positions, cfg.rope_theta)
    return q, k, v


def _einsum(eq, a, b):
    """einsum with JAX's dtype promotion (bf16 x f32 -> f32): the KV cache
    is bf16 even when the model computes in f32."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return torch.einsum(eq, a.to(dt), b.to(dt))


def out_project(o, wo):
    """(B, T, H*hd) attention output @ wo, promoted as JAX promotes: the
    output comes out of the cache's dtype (bf16) even in an f32 model."""
    dt = torch.promote_types(o.dtype, wo.dtype)
    return o.to(dt) @ wo.to(dt)


def _softmax_pv(s, v, eq):
    p = torch.softmax(s, dim=-1)
    return _einsum(eq, p.to(v.dtype), v)


# ---------------------------------------------------------------- reference
def attend_ref(q, k, v, causal=True, q_offset=0):
    """Full-materialisation attention. q: (B,T,H,hd); k,v: (B,S,KV,hd).
    Its (B, KV, G, T, S) f32 scores grow with the square of the length;
    ``attend`` takes ``attend_flash`` instead above ``FLASH_THRESHOLD``."""
    B, T, H, hd = q.shape
    S, KV = k.shape[1], k.shape[2]
    qg = q.reshape(B, T, KV, H // KV, hd)
    s = _einsum("btkgd,bskd->bkgts", qg, k).to(torch.float32) \
        * hd ** -0.5
    if causal:
        qpos = q_offset + torch.arange(T, device=q.device)[:, None]
        kpos = torch.arange(S, device=q.device)[None, :]
        s = torch.where(kpos <= qpos, s, NEG_INF)
    o = _softmax_pv(s, v, "bkgts,bskd->btkgd")
    return o.reshape(B, T, H, hd)


# ---------------------------------------------------------------- flash
def attend_flash(q, k, v, causal=True, q_chunk=Q_CHUNK, kv_chunk=KV_CHUNK):
    """Online-softmax attention through K4; no score tensor is stored.
    q: (B, T, H, hd); k, v: (B, S, KV, hd). ``q_chunk`` / ``kv_chunk`` are
    K4's ``block_q`` / ``block_k``; any lengths run (ragged chunks are
    masked). q, k and v are upcast to f32 and ``p @ v`` sums in f32, as in
    the Pallas kernel; the reference's jnp scan rounds p to the input dtype
    before ``p @ v``, so the two agree to bf16 rounding in bf16 and to the
    order of sums in f32. On the card, bf16 runs on the tensor cores and
    rounds p to bf16 before ``p @ v``, as the reference's scan does."""
    return flash_attention_bthd(q, k, v, causal=causal, block_q=q_chunk,
                                block_k=kv_chunk)


def attend(q, k, v, causal=True):
    """The no-cache attention of a forward: ``attend_flash`` when the
    sequence is longer than ``FLASH_THRESHOLD`` and q and k have one
    length, else ``attend_ref`` — the reference's switch."""
    T = q.shape[1]
    if T > FLASH_THRESHOLD and T == k.shape[1]:
        return attend_flash(q, k, v, causal=causal)
    return attend_ref(q, k, v, causal=causal)


# ---------------------------------------------------------------- cached
def attend_cached(q, cache_k, cache_v, pos):
    """Chunk attention against a KV cache (chunked prefill path).

    q: (B, T, H, hd) at absolute positions pos..pos+T-1; cache_k/v:
    (B, KV, S, hd) already written through pos+T-1. The mask keeps
    causality inside the chunk and hides unwritten cache positions, whose
    softmax weight is exactly 0.0 (the cache starts at zero, so the masked
    product adds 0 * 0)."""
    B, T, H, hd = q.shape
    KV, S = cache_k.shape[1], cache_k.shape[2]
    qg = q.reshape(B, T, KV, H // KV, hd)
    s = _einsum("btkgd,bksd->bkgts", qg, cache_k).to(torch.float32) \
        * hd ** -0.5
    qpos = pos + torch.arange(T, device=q.device)[:, None]
    kpos = torch.arange(S, device=q.device)[None, :]
    s = torch.where(kpos <= qpos, s, NEG_INF)
    o = _softmax_pv(s, cache_v, "bkgts,bksd->btkgd")
    return o.reshape(B, T, H, hd)


def attend_decode(q, cache_k, cache_v, pos):
    """One-token attention against a cache.

    q: (B, 1, H, hd); cache_k/v: (B, KV, S, hd); pos: int (tokens valid in
    cache INCLUDING the one just written at index pos), or a per-sequence
    (B,) tensor when sequences sit at different positions (fused
    multi-slot decode)."""
    B, _, H, hd = q.shape
    KV, S = cache_k.shape[1], cache_k.shape[2]
    qg = q.reshape(B, KV, H // KV, hd)
    s = _einsum("bkgd,bksd->bkgs", qg, cache_k).to(torch.float32) \
        * hd ** -0.5
    kpos = torch.arange(S, device=q.device)[None, None, None, :]
    if torch.is_tensor(pos) and pos.ndim == 1:
        pos = pos[:, None, None, None]
    s = torch.where(kpos <= pos, s, NEG_INF)
    o = _softmax_pv(s, cache_v, "bkgs,bksd->bkgd")
    return o.reshape(B, 1, H, hd)


def cache_update(cache_k, cache_v, k, v, pos: int, valid_end=None):
    """Write k, v (B, T, KV, hd) into the caches (B, KV, S, hd) at
    position ``pos``, in place. The start is clamped to [0, S - T] as
    ``jax.lax.dynamic_update_slice`` clamps it. With ``valid_end``, cache
    positions at or past it keep their contents (the padded tail of a
    layer-major prefill chunk never lands in the cache)."""
    T, S = k.shape[1], cache_k.shape[2]
    start = min(max(int(pos), 0), S - T)
    for cache, upd in ((cache_k, k), (cache_v, v)):
        upd = upd.transpose(1, 2).to(cache.dtype)
        window = cache[:, :, start:start + T]
        if valid_end is not None:
            keep = torch.arange(start, start + T, device=cache.device) \
                < valid_end
            upd = torch.where(keep[None, None, :, None], upd, window)
        window.copy_(upd)
    return cache_k, cache_v


def cache_update_batched(cache_k, cache_v, k, v, pos, active=None):
    """Per-sequence cache write, in place: row b of k, v (B, T, KV, hd)
    goes to the caches (B, KV, S, hd) at its own position ``pos[b]``
    (pos: (B,) int tensor on the caches' device), each start clamped to
    [0, S - T]. Rows whose ``active`` entry is False keep their cache
    contents (the reference's ``where(active, new, old)`` after the write).
    """
    B, T, KV, hd = k.shape
    S = cache_k.shape[2]
    start = pos.to(torch.int64).clamp(0, S - T)
    idx = start[:, None] + torch.arange(T, device=k.device)[None, :]
    idx = idx[:, None, :, None].expand(B, KV, T, hd)
    for cache, upd in ((cache_k, k), (cache_v, v)):
        upd = upd.transpose(1, 2).to(cache.dtype)
        if active is not None:
            old = cache.gather(2, idx)
            upd = torch.where(active[:, None, None, None], upd, old)
        cache.scatter_(2, idx, upd)
    return cache_k, cache_v


def attention_block(params, cfg, x, positions, cache=None, cache_pos=None):
    """Full attention sub-layer (pre-norm residual handled by the caller).

    Returns (out, cache). cache: dict(k=(B,KV,S,hd), v=...) or None; it is
    written in place."""
    B, T, _ = x.shape
    q, k, v = qkv_project(params, cfg, x, positions)
    if cache is None:
        o = attend(q, k, v, causal=True)
    else:
        ck, cv = cache_update(cache["k"], cache["v"], k, v, cache_pos)
        if T == 1:
            o = attend_decode(q, ck, cv, cache_pos)
        else:  # (chunked) prefill into cache: attend to the cached prefix
            o = attend_cached(q, ck, cv, cache_pos)
    out = out_project(o.reshape(B, T, cfg.n_heads * cfg.resolved_head_dim),
                      params["wo"])
    return out, cache
