"""Public model API: ``build_model(cfg)`` -> Model with init/apply, and the
bridge that carries the JAX package's parameters (as numpy) into the port.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.config import ModelConfig
from repro_torch.models import transformer


@dataclass
class Model:
    cfg: ModelConfig

    def init(self, gen: torch.Generator):
        return transformer.init_params(self.cfg, gen)

    def init_cache(self, batch, max_seq, device=None):
        return transformer.init_cache(self.cfg, batch, max_seq, device=device)

    def module(self, params) -> transformer.Transformer:
        return transformer.Transformer(self.cfg, params)

    def apply(self, params, batch, cache=None, cache_pos=None):
        return transformer.forward(params, self.cfg, batch, cache=cache,
                                   cache_pos=cache_pos)

    # ---------------- serving steps ----------------
    def prefill(self, params, batch, cache):
        """Write the prompt into the cache from position 0 (in place);
        returns (last_logits (B, 1, vocab), cache)."""
        logits, cache = self.apply(params, batch, cache=cache, cache_pos=0)
        return logits[:, -1:], cache

    def decode_step(self, params, token_batch, cache, pos):
        """One new token per sequence at position ``pos`` against a
        populated cache (written in place); returns (logits, cache)."""
        return self.apply(params, token_batch, cache=cache, cache_pos=pos)


def build_model(cfg: ModelConfig) -> Model:
    return Model(cfg=cfg)


def tensor_from_numpy(a: np.ndarray) -> torch.Tensor:
    """One array -> a tensor that owns its memory, bit for bit.

    ``torch.from_numpy`` rejects numpy's bfloat16 extension dtype, so bf16
    arrays go through their uint16 bit pattern. Arrays read back from JAX
    are read-only; the copy gives torch a writable buffer."""
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def params_from_numpy(tree):
    """The JAX package's param tree, given as nested dicts of numpy arrays
    (``jax.tree.map(np.asarray, params)``), as the port's tree: same keys,
    same stacked per-layer layout, same bits — MoE expert stacks with
    their int8 / packed int4 codes, scales and zero-points included."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v) for k, v in tree.items()}
    return tensor_from_numpy(np.asarray(tree))
