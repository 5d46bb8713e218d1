"""Decoder-only LM — dense, MoE and the VLM backbone: parameters, KV cache
and the monolithic forward.

An MoE layer holds ``"moe"`` (router and stacked experts, ``models.mlp``)
where a dense layer holds ``"ffn"``.

The vlm family is the dense decoder with M-RoPE and a stub frontend, as in
the reference: precomputed vision embeddings arrive in the batch
(``vision_embeds``, placed in front of the token embeddings) with their 3D
positions (``positions``, (3, B, T)); there are no vision parameters.

The parameters are a nested dict with the reference's layout: per-layer
leaves are stacked along a leading ``n_layers`` axis, so the executor
splits them per layer exactly as the reference does. ``Transformer`` is the
``nn.Module`` over that tree; ``forward`` is the same computation as a
plain function of the tree, which the monolithic checks call.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import mlp
from repro_torch.models.common import dtype_of, dense_init, rmsnorm, tree_map


def _check_family(cfg):
    if cfg.family not in ("dense", "moe", "vlm"):
        raise NotImplementedError(
            f"family={cfg.family!r} is not ported yet: the port runs dense "
            "and MoE decoders and the VLM backbone (audio, SSM and hybrid "
            "models are later slices)")


# ---------------------------------------------------------------- params
def init_layer_params(gen, cfg, dtype):
    p = {
        "ln1": torch.ones((cfg.d_model,), dtype=dtype, device=gen.device),
        "ln2": torch.ones((cfg.d_model,), dtype=dtype, device=gen.device),
        "attn": attn.init_attn_params(gen, cfg, dtype),
    }
    if cfg.moe is not None:
        p["moe"] = mlp.init_moe_params(gen, cfg, dtype)
    else:
        p["ffn"] = mlp.init_ffn_params(gen, cfg, dtype)
    return p


def init_params(cfg, gen: torch.Generator):
    """Seeded random weights, every leaf made on ``gen``'s device."""
    _check_family(cfg)
    dtype = dtype_of(cfg)
    layers = None
    for i in range(cfg.n_layers):
        lp = init_layer_params(gen, cfg, dtype)
        if layers is None:
            layers = tree_map(
                lambda t: t.new_empty((cfg.n_layers,) + tuple(t.shape)), lp)
        _assign_layer(layers, lp, i)
    p = {"embed": dense_init(gen, (cfg.vocab, cfg.d_model), 1, dtype),
         "layers": layers,
         "final_norm": torch.ones((cfg.d_model,), dtype=dtype,
                                 device=gen.device)}
    if not cfg.tie_embeddings:
        p["unembed"] = dense_init(gen, (cfg.d_model, cfg.vocab), 0, dtype)
    return p


def _assign_layer(stack, lp, i):
    for k, v in lp.items():
        if isinstance(v, dict):
            _assign_layer(stack[k], v, i)
        else:
            stack[k][i] = v


def layer_slice(layers, i):
    """Layer ``i``'s parameter tree (views into the stacked leaves)."""
    return tree_map(lambda t: t[i], layers)


def quantize_params(params, weight_quant, expert_quant="none"):
    """A float param tree with every layer's FFN (or MoE experts)
    quantised as ``init_params`` would under ``cfg.weight_quant`` (int8
    codes + scales, or packed int4 + scales + zeros) or, for MoE,
    ``cfg.expert_quant`` (int8 codes + one scale per expert), stacked per
    layer; other leaves are shared with ``params``. Lets one set of
    weights serve every mode."""
    key = "moe" if "moe" in params["layers"] else "ffn"
    if weight_quant == "fp16" and (key == "ffn" or expert_quant == "none"):
        return params
    tree = params["layers"][key]
    n_layers = next(iter(tree.values())).shape[0]
    per_layer = []
    for i in range(n_layers):
        lp = layer_slice(tree, i)
        if expert_quant == "int8":
            lp = mlp.quantize_experts_int8(lp)
        per_layer.append(mlp.quantize_weight_tree(lp, weight_quant))
    stacked = {k: torch.stack([lp[k] for lp in per_layer])
               for k in per_layer[0]}
    return {**params, "layers": {**params["layers"], key: stacked}}


# ---------------------------------------------------------------- cache
def init_cache(cfg, batch, max_seq, dtype=torch.bfloat16, device=None):
    """Stacked (L, B, KV, S, hd) caches, zero-filled: masked positions get
    a softmax weight of exactly 0.0, and 0 * 0 keeps them out of p @ v
    (``torch.empty`` could hold NaN, and 0 * NaN is NaN). They live on the
    card unless ``device="cpu"`` is passed."""
    device = resolve_device(device)
    shape = (cfg.n_layers, batch, cfg.n_kv_heads, max_seq,
             cfg.resolved_head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


# ---------------------------------------------------------------- forward
def layer_body(lp, cfg, x, positions, cache_kv, cache_pos):
    """One transformer layer. cache_kv: this layer's {"k", "v"} or None."""
    h, _ = attn.attention_block(lp["attn"], cfg,
                                rmsnorm(x, lp["ln1"], cfg.norm_eps),
                                positions, cache=cache_kv,
                                cache_pos=cache_pos)
    x = x + h
    hin = rmsnorm(x, lp["ln2"], cfg.norm_eps)
    if cfg.moe is not None:
        return x + mlp.moe_block(lp["moe"], cfg, hin)
    return x + mlp.ffn(lp["ffn"], cfg, hin)


def logits_head(params, cfg, x):
    if cfg.tie_embeddings:
        return x @ params["embed"].T
    return x @ params["unembed"]


def forward(params, cfg, batch, cache=None, cache_pos=None):
    """Returns (logits, cache). batch: {"tokens": (B, T) int tensor}, and
    for the vlm family optionally "vision_embeds" (B, nv, d), placed in
    front of the tokens, and "positions" (3, B, T) for M-RoPE (required);
    cache: stacked KV dict, written in place. ``params["layers"]`` is the
    stacked tree, or a list of per-layer trees (an MoE layer's possibly
    split per expert, ``mlp.split_experts``)."""
    _check_family(cfg)
    tokens = batch["tokens"]
    B = tokens.shape[0]
    x = params["embed"][tokens.to(torch.int64)]
    if cfg.family == "vlm" and "vision_embeds" in batch:
        x = torch.cat([batch["vision_embeds"].to(x.dtype), x], dim=1)
    T = x.shape[1]
    if cfg.pos == "mrope":
        positions = batch["positions"]
    else:
        base = cache_pos if cache_pos is not None else 0
        positions = (base + torch.arange(T, device=x.device))[None, :] \
            .expand(B, T)
    layers = params["layers"]
    for i in range(cfg.n_layers):
        lp = layers[i] if isinstance(layers, list) else layer_slice(layers, i)
        ckv = None if cache is None else {"k": cache["k"][i],
                                          "v": cache["v"][i]}
        x = layer_body(lp, cfg, x, positions, ckv, cache_pos)
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return logits_head(params, cfg, x), cache


class _Tree(nn.Module):
    """A nested dict of tensors held as (frozen) module parameters."""

    def __init__(self, tree):
        super().__init__()
        self._keys = list(tree)
        for k, v in tree.items():
            if isinstance(v, dict):
                setattr(self, k, _Tree(v))
            else:
                setattr(self, k, nn.Parameter(v, requires_grad=False))

    def tree(self):
        return {k: (getattr(self, k).tree() if isinstance(getattr(self, k),
                                                          _Tree)
                    else getattr(self, k).data) for k in self._keys}


class Transformer(nn.Module):
    """The monolithic decoder as an ``nn.Module``. Its state is the
    param tree (``tree()``) that the executor splits per sub-layer."""

    def __init__(self, cfg, params):
        super().__init__()
        _check_family(cfg)
        self.cfg = cfg
        self.params = _Tree(params)

    def tree(self):
        return self.params.tree()

    @torch.no_grad()
    def forward(self, tokens, cache=None, cache_pos=None, **inputs):
        """``inputs``: the vlm family's ``vision_embeds`` and
        ``positions``."""
        return forward(self.tree(), self.cfg, {"tokens": tokens, **inputs},
                       cache=cache, cache_pos=cache_pos)
