"""FFN sub-layers: dense (swiglu / gelu) and capacity-based MoE, with
grouped int8 / packed int4 weight quantisation (``cfg.weight_quant``) and
per-expert int8 experts (``cfg.expert_quant``).

MoE dispatch is the reference's GShard-style fixed capacity, built with
scatter and gather: the router picks each token's top-k experts, every
kept (token, choice) lands in its expert's capacity buffer, each expert
computes its rows, and the combine sums each token's gate-weighted outputs.
The expert compute is per expert: ``expert_ffn`` runs one expert's three
matmuls through the streamed kernels (``_mm_dispatch``: K1, K2 or K3 by
the weight's format) on that expert's rows of the buffer, and runs only
for experts that were routed to. No (E, d, f) weight stack is built: the
reference's batched einsum over the stack (``_expert_compute``) has no
counterpart here, so the monolithic ``moe_ffn`` and the executor's
expert-granular phases share ``expert_ffn`` and give the same bits.

Where the reference depends on an order, the port fixes it:
- top-k takes the first k of a stable descending sort, so equal
  probabilities go to the lower expert index first, as ``jax.lax.top_k``;
- the dispatch writes each kept row into its own (expert, position) slot
  by a copy, never by an add whose order could matter; rows that are not
  kept go to a sink row that is dropped;
- the combine sums each token's top-k outputs in k order with one rounding
  per add, as the reference's scatter-add applies its updates on the CPU
  (``index_add_`` on CUDA adds by atomics in no fixed order, and one sum
  over k rounds once).

The reference's expert-parallel ``moe_ffn_ep`` is a ``shard_map`` over a
device mesh; on one GPU it has no counterpart and ``moe_block`` is
``moe_ffn``.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.device import is_fake
from repro_torch.kernels.streamed_matmul import (GROUP_SIZE, _f32,
                                                 dequant_int4, dequant_int8,
                                                 quantize_int4,
                                                 quantize_int8,
                                                 streamed_matmul,
                                                 streamed_matmul_int4,
                                                 streamed_matmul_int8)
from repro_torch.models.common import dense_init

# one expert's leaves: weight matrices, then scales and int4 zero-points
EXPERT_KEYS = ("w_gate", "w_up", "w_down", "s_gate", "s_up", "s_down",
               "z_gate", "z_up", "z_down")


# ----------------------------------------------------- weight quantisation
def _quantize(w, weight_quant):
    """One (K, N) matrix, or a stack of them along leading axes quantised
    one matrix at a time (the reference vmaps its quantiser over them)."""
    if w.ndim > 2:
        parts = [_quantize(w[i], weight_quant) for i in range(w.shape[0])]
        return tuple(torch.stack(t) for t in zip(*parts))
    if weight_quant == "int8":
        return quantize_int8(w, block_k=GROUP_SIZE)
    return quantize_int4(w)


def quantize_weight_tree(p, weight_quant):
    """Quantise every ``w_*`` matrix in a param dict at install time:
    2-D weights directly, stacked (E, K, N) expert weights per expert.
    Adds ``s_*`` scales (and ``z_*`` zero-points for int4) next to each
    quantised ``w_*``: int8 codes with (..., G, 1, N) f32 scales, or packed
    int4 codes with (..., G, N) fp16 scales and uint8 zeros."""
    if weight_quant == "fp16":
        return p
    out = dict(p)
    for k in list(p):
        if not k.startswith("w_"):
            continue
        qs = _quantize(p[k], weight_quant)
        out[k], out[f"s_{k[2:]}"] = qs[0], qs[1]
        if weight_quant == "int4":
            out[f"z_{k[2:]}"] = qs[2]
    return out


def quantize_experts_int8(p):
    """``expert_quant="int8"``: each expert's matrices as int8 codes with
    one f32 scale per expert, ``max |w| / 127`` over the expert's matrix
    (at least 1e-8), shaped (..., E, 1, 1); byte-equal to the reference's.
    Takes (E, K, N) stacks, or stacks with more leading axes."""
    out = dict(p)
    for k in ("w_gate", "w_up", "w_down"):
        w = p[k].to(torch.float32)
        scale = torch.amax(torch.abs(w), dim=(-2, -1), keepdim=True) \
            / _f32(127, w)
        scale = torch.maximum(scale, _f32(1e-8, w))
        out[k] = torch.clamp(torch.round(w / scale), -127, 127) \
            .to(torch.int8)
        out[f"s_{k[2:]}"] = scale
    return out


def _dequant(params, name, compute_dtype=torch.bfloat16):
    """``params[name]`` as a ``compute_dtype`` matrix: packed int4, grouped
    int8 and per-expert int8 dequantised, float weights as they are."""
    w = params[name]
    if w.dtype == torch.uint8:  # packed int4 + per-group scale/zero
        return dequant_int4(w, params[f"s_{name[2:]}"],
                            params[f"z_{name[2:]}"]).to(compute_dtype)
    if w.dtype == torch.int8:
        s = params[f"s_{name[2:]}"]
        if s.ndim == w.ndim + 1:  # grouped along K (weight_quant="int8")
            return dequant_int8(w, s).to(compute_dtype)
        return (w.to(torch.float32) * s).to(compute_dtype)
    return w


def _mm_dispatch(x2, p, name):
    """One matmul through the streamed kernel of the weight's storage
    format, dequantisation fused into the kernel for the quantised ones:
    K3 for packed int4, K2 for int8, K1 for float weights. A per-expert
    int8 weight (``expert_quant``) is one K2 group: its (1, 1) scale is
    broadcast to (1, 1, N) where it lies, after the copy that brought it
    there, so the link carries the 4 bytes the graph prices."""
    w = p[name]
    if w.dtype == torch.uint8:   # packed int4
        return streamed_matmul_int4(x2, w, p[f"s{name[1:]}"],
                                    p[f"z{name[1:]}"])
    if w.dtype == torch.int8:
        s = p[f"s{name[1:]}"]
        if s.ndim == w.ndim:     # per expert: one scale
            s = s.reshape(1, 1, 1).expand(1, 1, w.shape[-1]).contiguous()
        return streamed_matmul_int8(x2, w, s)
    return streamed_matmul(x2, w)


# ---------------------------------------------------------------- dense ffn
def init_ffn_params(gen, cfg, dtype, d_ff=None):
    d = cfg.d_model
    f = d_ff or cfg.d_ff
    if cfg.mlp == "swiglu":
        p = {
            "w_gate": dense_init(gen, (d, f), 0, dtype),
            "w_up": dense_init(gen, (d, f), 0, dtype),
            "w_down": dense_init(gen, (f, d), 0, dtype),
        }
    else:
        p = {
            "w_up": dense_init(gen, (d, f), 0, dtype),
            "w_down": dense_init(gen, (f, d), 0, dtype),
        }
    return quantize_weight_tree(p, cfg.weight_quant)


def _silu_mul(gate, up):
    """silu(gate) * up, silu written op for op as the reference lowers it,
    x * (1 / (1 + exp(-x))), so bf16 rounds after each op as it does
    there."""
    return gate * (1 / (1 + torch.exp(-gate))) * up


def activate(cfg, gate, up):
    """The FFN hidden: silu(gate) * up (swiglu), relu(up)^2 (relu2,
    nemotron-h) or gelu(up), the tanh approximation as jax.nn.gelu's
    default."""
    if cfg.mlp == "swiglu":
        return _silu_mul(gate, up)
    if cfg.mlp == "relu2":
        return torch.relu(up).square()
    return F.gelu(up, approximate="tanh")


def ffn(params, cfg, x):
    """The monolithic FFN: each weight dequantised to ``x.dtype``, then
    ``@``, as the reference's ``mlp.ffn``."""
    def w(name):
        return _dequant(params, name, x.dtype)
    if cfg.mlp == "swiglu":
        h = activate(cfg, x @ w("w_gate"), x @ w("w_up"))
    else:
        h = activate(cfg, None, x @ w("w_up"))
    return h @ w("w_down")


# ---------------------------------------------------------------- moe
def init_moe_params(gen, cfg, dtype):
    """f32 router (d, E) and stacked (E, d, f) / (E, f, d) expert weights;
    per-expert int8 under ``expert_quant``, grouped under
    ``weight_quant``."""
    m = cfg.moe
    d, f, E = cfg.d_model, m.d_expert, m.n_experts
    p = {
        "router": dense_init(gen, (d, E), 0, torch.float32),
        "w_gate": dense_init(gen, (E, d, f), 1, dtype),
        "w_up": dense_init(gen, (E, d, f), 1, dtype),
        "w_down": dense_init(gen, (E, f, d), 1, dtype),
    }
    if cfg.expert_quant == "int8":
        p = quantize_experts_int8(p)
    return quantize_weight_tree(p, cfg.weight_quant)


def split_experts(p):
    """A layer's MoE tree with its expert stacks split per expert:
    ``{"router", "experts": {e: {"w_gate": ..., ...}}}``, each expert's
    leaves views of the stacks. Moved to the card, it is E trees of
    their own and no (E, ...) stack."""
    E = p["router"].shape[-1]
    keys = [k for k in EXPERT_KEYS if k in p]
    return {"router": p["router"],
            "experts": {e: {k: p[k][e] for k in keys} for e in range(E)}}


def expert_tree(p, e):
    """Expert ``e``'s leaves from a layer's MoE tree, stacked or split."""
    if "experts" in p:
        return p["experts"][e]
    return {k: p[k][e] for k in EXPERT_KEYS if k in p}


def _route(x, router, m):
    """x: (T, d) -> (gates (T, k), experts (T, k), probs (T, E)). The
    logits are ``x.f32 @ router`` through K1 in f32, whose rows do not
    depend on T; top-k is the first k of a stable descending sort (ties
    to the lower index, as ``jax.lax.top_k``)."""
    logits = streamed_matmul(x.to(torch.float32).contiguous(), router)
    probs = torch.softmax(logits, dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, idx = vals[:, :m.top_k], idx[:, :m.top_k]
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    return gates, idx, probs


def _dispatch_positions(idx, n_local, keep_mask):
    """Position of each (token, choice) in its expert's capacity buffer:
    the exclusive running count of kept assignments per expert. idx: (A,)
    local expert ids in [0, n_local); keep_mask: (A,) bool. The one-hot is
    ``idx == arange``, which ``F.one_hot`` computes for these ids too, but
    by one set of ops on every device: ``F.one_hot`` checks its ids on the
    host's tensors only and takes other ops for a fake tensor, so a count
    would see the card's step and a CPU step differ."""
    onehot = (idx[:, None] == torch.arange(n_local, device=idx.device)) \
        .to(torch.int64) * keep_mask[:, None].to(torch.int64)
    pos_in_expert = torch.cumsum(onehot, dim=0) - onehot
    return (pos_in_expert * onehot).sum(-1)


def moe_dispatch(x, gates, idx, m, n_local, local_offset, capacity):
    """Masked-capacity dispatch: each kept (token, choice) row is copied
    into its expert's capacity buffer. Returns ``(disp, aux)``: the
    (n_local, capacity, d) expert input buffer, zero where no row was
    kept, and the coordinates ``(safe_idx, safe_pos, keep, flat_gate,
    token_of)`` that ``moe_combine`` gathers through. Kept rows have
    distinct slots; the others go to one sink row past the buffer."""
    T, d = x.shape
    A = T * m.top_k
    flat_idx = idx.reshape(A) - local_offset
    flat_gate = gates.reshape(A)
    token_of = torch.arange(T, device=x.device).repeat_interleave(m.top_k)
    local = (flat_idx >= 0) & (flat_idx < n_local)
    safe_idx = torch.where(local, flat_idx, 0)
    pos = _dispatch_positions(safe_idx, n_local, local)
    keep = local & (pos < capacity)
    safe_pos = torch.where(keep, pos, capacity - 1)
    sink = n_local * capacity
    slot = torch.where(keep, safe_idx * capacity + safe_pos, sink)
    buf = torch.zeros((sink + 1, d), dtype=x.dtype, device=x.device)
    buf.index_copy_(0, slot, x[token_of])
    disp = buf[:sink].view(n_local, capacity, d)
    return disp, (safe_idx, safe_pos, keep, flat_gate, token_of)


def moe_combine(out_buf, aux, n_tokens, dtype):
    """Gather expert outputs back to token order, weight each by its gate
    (cast to ``dtype`` first, as the reference) and sum each token's top-k
    contributions in k order, rounding after every add."""
    safe_idx, safe_pos, keep, flat_gate, _ = aux
    d = out_buf.shape[-1]
    g = out_buf[safe_idx, safe_pos]                    # (A, d)
    g = g * (flat_gate * keep.to(torch.float32)).to(dtype)[:, None]
    g = g.reshape(n_tokens, -1, d)
    out = torch.zeros((n_tokens, d), dtype=dtype, device=out_buf.device)
    for j in range(g.shape[1]):
        out = out + g[:, j]
    return out


def routed_experts(idx, n_experts):
    """The sorted expert ids ``idx`` selects, read on the host; the
    out-of-range id E that padded positions carry is left out. A fake
    ``idx`` (a count's specs, ``launch/counting.py``) has no ids to read:
    every expert counts as routed, over its capacity rows, the static
    bound that the reference's graph computes."""
    if is_fake(idx):
        return list(range(n_experts))
    ids = np.unique(idx.cpu().numpy())
    return [int(e) for e in ids if e < n_experts]


def expert_ffn(p_e, rows):
    """One expert's swiglu FFN on its (C, d) rows of the dispatch buffer,
    every matmul through ``_mm_dispatch``. The kernels' rows do not depend
    on C, so an expert's result is the same whichever path calls it."""
    h = _silu_mul(_mm_dispatch(rows, p_e, "w_gate"),
                  _mm_dispatch(rows, p_e, "w_up"))
    return _mm_dispatch(h, p_e, "w_down")


def moe_experts(experts, disp, out_buf):
    """``out_buf[e] = expert_ffn(tree, disp[e])`` for each ``(e, tree)`` of
    ``experts``; the other experts' rows of ``out_buf`` stay as they
    are (zero: the combine gathers nothing from them)."""
    for e, p_e in experts:
        out_buf[e] = expert_ffn(p_e, disp[e])


def _moe_local(x, params, cfg, capacity, valid=None):
    """MoE over a token set, x: (T, d) -> (T, d). ``valid`` (optional (T,)
    bool) masks padded tokens: they route to the out-of-range expert id E,
    so they claim no capacity and contribute nothing to the combine."""
    m = cfg.moe
    T, d = x.shape
    gates, idx, _ = _route(x, params["router"], m)
    if valid is not None:
        idx = torch.where(valid[:, None], idx, m.n_experts)
    disp, aux = moe_dispatch(x, gates, idx, m, m.n_experts, 0, capacity)
    out_buf = torch.zeros_like(disp)
    moe_experts(((e, expert_tree(params, e))
                 for e in routed_experts(idx, m.n_experts)), disp, out_buf)
    return moe_combine(out_buf, aux, T, x.dtype)


DROPLESS_MAX_ASSIGN = 4096


def capacity_is_dropless(n_tokens, m) -> bool:
    """True when ``capacity_of`` is in its dropless regime: capacity ==
    n_tokens bounds every expert's worst-case load, so no assignment can
    be dropped. Layer-major prefill may pad a tail chunk only here."""
    return n_tokens * m.top_k <= DROPLESS_MAX_ASSIGN


def capacity_of(n_tokens, m):
    """Expert capacity: ``n_tokens`` for small token counts (dropless:
    top-k experts are distinct per token, so no expert gets more), else
    the GShard capacity-factor truncation."""
    if capacity_is_dropless(n_tokens, m):
        return n_tokens
    return max(1, int(n_tokens * m.top_k * m.capacity_factor / m.n_experts))


def moe_ffn(params, cfg, x, valid=None):
    """Single-device MoE. x: (B, T, d); ``valid`` (optional (B, T) bool)
    marks real tokens, the others route to no expert. ``params`` is the
    layer's MoE tree, stacked or split (``split_experts``)."""
    B, T, d = x.shape
    xf = x.reshape(B * T, d)
    out = _moe_local(xf, params, cfg, capacity_of(B * T, cfg.moe),
                     valid=None if valid is None else valid.reshape(B * T))
    return out.reshape(B, T, d)


def moe_block(params, cfg, x):
    return moe_ffn(params, cfg, x)
