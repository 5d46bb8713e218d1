"""Hybrids: zamba2's Mamba2 backbone with one shared transformer block,
and nemotron-h's one mixer a layer (``cfg.layer_pattern``).

Layout: ``n_layers`` Mamba2 layers; after every ``shared_attn_every``-th
mamba layer the single *shared* transformer block (attention + FFN, one
set of weights) is applied, each application with its own KV cache.

The parameters keep the reference's stacked layout: ``groups`` holds the
mamba layers of the full groups as (n_grp, per, ...) leaves, ``tail`` the
leftover layers as (rem, ...) leaves, ``shared`` the one block. The
reference scans over groups and layers; here they are loops over the
stacked slices. The cache holds every layer's mamba state, (n_grp * per,
...) for the groups and (rem, ...) for the tail, and one KV cache per
shared-block application, (n_grp, B, KV, S, hd); ``forward`` writes it in
place and returns it.

A patterned hybrid keeps each mixer kind stacked over the layers of that
kind, with every layer's pre-norm in one (L, d) leaf: ``layers = {"ln",
"mamba", "ffn", "attn"}``. The Mamba-2 leaves hold nemotron-h's fused
in-projection ``w_in`` (z, xBC, dt), ``conv_w`` and ``conv_b``,
``a_log``, ``dt_bias`` and ``d_skip`` in f32, ``gate_norm`` and
``w_out``. Such a model is served by the executor alone
(``pattern_layers`` gives its per-layer trees) from the caller's weights;
it has no init and no monolithic forward here.
"""
from __future__ import annotations

import torch

from repro_torch.device import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import mlp, ssm
from repro_torch.models.common import (dense_init, dtype_of, remat_call,
                                       rmsnorm, stacked, tree_map)
from repro_torch.models.transformer import Monolithic, layer_slice


def _n_groups(cfg):
    return cfg.n_layers // cfg.shared_attn_every


def _n_rem(cfg):
    return cfg.n_layers - _n_groups(cfg) * cfg.shared_attn_every


def _mamba_layer_init(gen, cfg, dtype):
    return {"ln": torch.ones((cfg.d_model,), dtype=dtype, device=gen.device),
            "mamba": ssm.init_mamba_params(gen, cfg, dtype)}


# the tree of each kind's layer as the executor's sub-layers take it
_PATTERN_TREE = {"M": ("mamba", "ln"), "-": ("ffn", "ln2"),
                 "*": ("attn", "ln1")}


def pattern_index(pattern):
    """Each layer's index among the layers of its own kind."""
    seen = {k: 0 for k in _PATTERN_TREE}
    out = []
    for k in pattern:
        out.append(seen[k])
        seen[k] += 1
    return out


def pattern_layers(layers, pattern):
    """Layer ``i``'s tree (views into the stacked leaves) for each layer
    of ``pattern``: ``{"mamba", "ln"}``, ``{"ffn", "ln2"}`` or
    ``{"attn", "ln1"}``."""
    out = []
    for i, (k, j) in enumerate(zip(pattern, pattern_index(pattern))):
        mixer, norm = _PATTERN_TREE[k]
        out.append({mixer: layer_slice(layers[mixer], j),
                    norm: layers["ln"][i]})
    return out


def _served_only(cfg):
    if cfg.layer_pattern:
        raise NotImplementedError(
            f"{cfg.name}: a patterned hybrid is served by the executor "
            "from the caller's weights (Session.open(..., params=...)), "
            "in the layout this module's docstring gives")


def init_params(cfg, gen: torch.Generator):
    """Seeded random weights, every leaf made on ``gen``'s device."""
    _served_only(cfg)
    dtype = dtype_of(cfg)
    n_grp, rem = _n_groups(cfg), _n_rem(cfg)
    per = cfg.shared_attn_every
    dev = gen.device
    p = {
        "embed": dense_init(gen, (cfg.vocab, cfg.d_model), 1, dtype),
        "groups": tree_map(
            lambda t: t.view((n_grp, per) + tuple(t.shape[1:])),
            stacked(lambda: _mamba_layer_init(gen, cfg, dtype),
                     n_grp * per)),
        "shared": {
            "ln1": torch.ones((cfg.d_model,), dtype=dtype, device=dev),
            "ln2": torch.ones((cfg.d_model,), dtype=dtype, device=dev),
            "attn": attn.init_attn_params(gen, cfg, dtype),
            "ffn": mlp.init_ffn_params(gen, cfg, dtype),
        },
        "final_norm": torch.ones((cfg.d_model,), dtype=dtype, device=dev),
        "unembed": dense_init(gen, (cfg.d_model, cfg.vocab), 0, dtype),
    }
    if rem:
        p["tail"] = stacked(lambda: _mamba_layer_init(gen, cfg, dtype),
                             rem)
    return p


def init_cache(cfg, batch, max_seq, dtype=torch.bfloat16, device=None):
    """Mamba states for every layer (zeros) + a zero-filled KV cache per
    shared-block application, on the card unless ``device="cpu"``."""
    _served_only(cfg)
    device = resolve_device(device)
    n_grp, rem = _n_groups(cfg), _n_rem(cfg)
    per = cfg.shared_attn_every

    def states(n):
        s = ssm.init_mamba_state(cfg, batch, device)
        return {k: v[None].repeat((n,) + (1,) * v.ndim)
                for k, v in s.items()}

    kv = (n_grp, batch, cfg.n_kv_heads, max_seq, cfg.resolved_head_dim)
    cache = {
        "groups": states(n_grp * per),
        "kv_k": torch.zeros(kv, dtype=dtype, device=device),
        "kv_v": torch.zeros(kv, dtype=dtype, device=device),
    }
    if rem:
        cache["tail"] = states(rem)
    return cache


def _mamba_layer(lp, cfg, x, states, i):
    """One residual mamba layer; ``states`` (stacked, or None) is read at
    row ``i`` and written there in place."""
    state = None if states is None else {k: v[i] for k, v in states.items()}
    h, new = ssm.mamba_block(lp["mamba"], cfg,
                             rmsnorm(x, lp["ln"], cfg.norm_eps), state)
    if states is not None:
        for k, v in states.items():
            v[i].copy_(new[k])
    return x + h


def _shared_block(sp, cfg, x, positions, cache_kv, cache_pos):
    h, _ = attn.attention_block(sp["attn"], cfg,
                                rmsnorm(x, sp["ln1"], cfg.norm_eps),
                                positions, cache=cache_kv,
                                cache_pos=cache_pos)
    x = x + h
    return x + mlp.ffn(sp["ffn"], cfg, rmsnorm(x, sp["ln2"], cfg.norm_eps))


def _promote_conv(states, dtype):
    """The reference's conv state takes the model's dtype on its first
    write (a bf16 history concatenated with f32 inputs is f32); the port's
    stacked state follows it once, so an f32 model keeps f32 history."""
    if states is not None:
        want = torch.promote_types(states["conv"].dtype, dtype)
        if states["conv"].dtype != want:
            states["conv"] = states["conv"].to(want)


def _group(params, cfg, gp, x, gstates, g, positions, ckv, cache_pos):
    """Group ``g``: its ``shared_attn_every`` mamba layers, then the shared
    attention block."""
    per = cfg.shared_attn_every
    for j in range(per):
        x = _mamba_layer(layer_slice(gp, j), cfg, x, gstates, g * per + j)
    return _shared_block(params["shared"], cfg, x, positions, ckv,
                         cache_pos)


def forward(params, cfg, batch, cache=None, cache_pos=None, remat="none"):
    """Returns (logits (B, T, V), cache). batch: {"tokens": (B, T)}; cache
    (``init_cache``) is written in place. ``remat="full"`` recomputes each
    group (its mamba layers and the shared block) in the backward; as in
    the reference, the tail is not recomputed and ``"dots"`` is
    ``"none"``."""
    _served_only(cfg)
    tokens = batch["tokens"]
    B, T = tokens.shape
    n_grp, rem = _n_groups(cfg), _n_rem(cfg)
    x = params["embed"][tokens.to(torch.int64)]
    base = cache_pos if cache_pos is not None else 0
    positions = (base + torch.arange(T, device=x.device))[None, :] \
        .expand(B, T)
    gstates = None if cache is None else cache["groups"]
    tstates = None if cache is None or not rem else cache["tail"]
    _promote_conv(gstates, x.dtype)
    _promote_conv(tstates, x.dtype)
    group_remat = "full" if remat == "full" else "none"
    for g in range(n_grp):
        ckv = None if cache is None else {"k": cache["kv_k"][g],
                                          "v": cache["kv_v"][g]}
        x = remat_call(_group, group_remat, params, cfg,
                       layer_slice(params["groups"], g), x, gstates, g,
                       positions, ckv, cache_pos)
    for j in range(rem):
        x = _mamba_layer(layer_slice(params["tail"], j), cfg, x, tstates, j)
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return x @ params["unembed"], cache


class Hybrid(Monolithic):
    """The monolithic hybrid model as an ``nn.Module``."""

    def __init__(self, cfg, params):
        super().__init__(cfg, params, forward)


def module(cfg, params) -> Hybrid:
    return Hybrid(cfg, params)
