"""xLSTM LM: alternating mLSTM / sLSTM residual blocks, the head tied to
the embedding.

Blocks carry their own projections (``d_ff = 0``). The two block kinds
have different parameter trees, so the parameters keep the reference's
layout of stacked *pairs* (mLSTM + sLSTM), (n_pairs, ...) leaves; the
reference scans over them, here a loop runs over the stacked slices. The
cache holds each pair's mLSTM matrix memory ``m`` (n_pairs, B, H, hd+1,
hd) and sLSTM states ``s`` = {c, n, y}, each (n_pairs, B, d), all f32;
``forward`` writes it in place and returns it.
"""
from __future__ import annotations

import torch

from repro_torch.device import resolve_device
from repro_torch.models import ssm
from repro_torch.models.common import (dense_init, dtype_of, remat_call,
                                       rmsnorm, stacked)
from repro_torch.models.transformer import Monolithic, layer_slice


def _n_pairs(cfg):
    assert cfg.n_layers % 2 == 0, "xlstm config uses mLSTM/sLSTM pairs"
    return cfg.n_layers // 2


def init_params(cfg, gen: torch.Generator):
    """Seeded random weights, every leaf made on ``gen``'s device."""
    dtype = dtype_of(cfg)
    dev = gen.device

    def pair():
        return {
            "m_ln": torch.ones((cfg.d_model,), dtype=dtype, device=dev),
            "m": ssm.init_mlstm_params(gen, cfg, dtype),
            "s_ln": torch.ones((cfg.d_model,), dtype=dtype, device=dev),
            "s": ssm.init_slstm_params(gen, cfg, dtype),
        }

    return {
        "embed": dense_init(gen, (cfg.vocab, cfg.d_model), 1, dtype),
        "pairs": stacked(pair, _n_pairs(cfg)),
        "final_norm": torch.ones((cfg.d_model,), dtype=dtype, device=dev),
    }


def init_cache(cfg, batch, max_seq=None, device=None):  # noqa: ARG001
    """Zero states for every pair, on the card unless ``device="cpu"``.
    ``max_seq`` is unused: the states do not grow with the sequence."""
    device = resolve_device(device)
    n = _n_pairs(cfg)
    m = ssm.init_mlstm_state(cfg, batch, device)
    return {
        "m": m[None].repeat((n,) + (1,) * m.ndim),
        "s": {k: torch.zeros((n, batch, cfg.d_model), dtype=torch.float32,
                             device=device)
              for k in ("c", "n", "y")},
    }


def _pair(pp, cfg, x, cache, i):
    """Pair ``i``: the mLSTM block, then the sLSTM block; returns (x, the
    new mLSTM state, the new sLSTM states)."""
    mstate = None if cache is None else cache["m"][i]
    h, new_m = ssm.mlstm_block(pp["m"], cfg,
                               rmsnorm(x, pp["m_ln"], cfg.norm_eps), mstate)
    x = x + h
    sstate = None if cache is None else \
        {k: v[i] for k, v in cache["s"].items()}
    h, new_s = ssm.slstm_block(pp["s"], cfg,
                               rmsnorm(x, pp["s_ln"], cfg.norm_eps), sstate)
    return x + h, new_m, new_s


def forward(params, cfg, batch, cache=None, cache_pos=None,  # noqa: ARG001
            remat="none"):
    """Returns (logits (B, T, V), cache). batch: {"tokens": (B, T)}; cache
    (``init_cache``) is written in place. The recurrence needs no
    position, so ``cache_pos`` is unused. ``remat="full"`` recomputes each
    pair in the backward; as in the reference, ``"dots"`` is
    ``"none"``."""
    x = params["embed"][batch["tokens"].to(torch.int64)]
    pair_remat = "full" if remat == "full" else "none"
    for i in range(_n_pairs(cfg)):
        x, new_m, new_s = remat_call(_pair, pair_remat,
                                     layer_slice(params["pairs"], i), cfg,
                                     x, cache, i)
        if cache is not None:
            cache["m"][i].copy_(new_m)
            for k, v in cache["s"].items():
                v[i].copy_(new_s[k])
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return x @ params["embed"].T, cache


class XLSTM(Monolithic):
    """The monolithic xLSTM model as an ``nn.Module``."""

    def __init__(self, cfg, params):
        super().__init__(cfg, params, forward)


def module(cfg, params) -> XLSTM:
    return XLSTM(cfg, params)
