"""Public model API: ``build_model(cfg)`` -> Model with init/apply/loss, the
masked LM ``cross_entropy``, and the bridge that carries the JAX package's
parameters (as numpy) into the port.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.config import ModelConfig
from repro_torch.models import hybrid, transformer, xlstm

_FAMILY_MODULES = {
    "dense": transformer,
    "moe": transformer,
    "vlm": transformer,
    "audio": transformer,
    "hybrid": hybrid,
    "ssm": xlstm,
}


@dataclass
class Model:
    cfg: ModelConfig

    @property
    def impl(self):
        """The family's model module (``_FAMILY_MODULES``)."""
        return _FAMILY_MODULES[self.cfg.family]

    def init(self, gen: torch.Generator):
        return self.impl.init_params(self.cfg, gen)

    def init_cache(self, batch, max_seq, device=None):
        return self.impl.init_cache(self.cfg, batch, max_seq, device=device)

    def module(self, params) -> torch.nn.Module:
        """The family's ``nn.Module`` over ``params``."""
        return self.impl.module(self.cfg, params)

    def apply(self, params, batch, cache=None, cache_pos=None,
              remat="none"):
        """``remat``: ``"none"``, ``"full"`` (each layer, group or pair
        recomputed in the backward) or ``"dots"`` (the dense decoder's
        layers keep their 2-D products' outputs), as the reference's."""
        return self.impl.forward(params, self.cfg, batch, cache=cache,
                                 cache_pos=cache_pos, remat=remat)

    # ---------------- loss ----------------
    def loss(self, params, batch, remat="none"):
        logits, _ = self.apply(params, batch, remat=remat)
        return cross_entropy(self.cfg, logits, batch)

    # ---------------- serving steps ----------------
    def prefill(self, params, batch, cache):
        """Write the prompt into the cache from position 0 (in place);
        returns (last_logits (B, 1, ...), cache)."""
        logits, cache = self.apply(params, batch, cache=cache, cache_pos=0)
        return logits[:, -1:], cache

    def decode_step(self, params, token_batch, cache, pos):
        """One new token per sequence at position ``pos`` against a
        populated cache (written in place); returns (logits, cache)."""
        return self.apply(params, token_batch, cache=cache, cache_pos=pos)


def build_model(cfg: ModelConfig) -> Model:
    return Model(cfg=cfg)


# ---------------------------------------------------------------- loss
def cross_entropy(cfg, logits, batch):  # noqa: ARG001
    """Masked LM cross-entropy in f32, the reference's math op for op: the
    row max detached, ``log(sum(exp(lg - max))) + max``, the label's logit
    picked by an iota mask (a sum over the vocab of ``where(iota == label,
    lg, 0)``), and the mean over ``loss_mask`` (all ones when absent)
    divided by ``max(sum(mask), 1)``. logits: (B, T, V), or (B, T, nq, V)
    for the audio family; labels: logits' shape without V."""
    labels = batch["labels"].to(torch.int64)
    lg = logits.to(torch.float32)
    m = lg.amax(dim=-1, keepdim=True).detach()
    lse = torch.log(torch.sum(torch.exp(lg - m), dim=-1)) + m[..., 0]
    vocab_iota = torch.arange(lg.shape[-1], device=lg.device)
    label_logit = torch.sum(
        torch.where(vocab_iota == labels[..., None], lg, 0.0), dim=-1)
    nll = lse - label_logit
    mask = batch.get("loss_mask")
    if mask is None:
        mask = torch.ones(labels.shape, dtype=torch.float32,
                          device=lg.device)
    mask = mask.to(torch.float32)
    one = torch.ones((), dtype=torch.float32, device=lg.device)
    return torch.sum(nll * mask) / torch.maximum(torch.sum(mask), one)


def tensor_from_numpy(a: np.ndarray) -> torch.Tensor:
    """One array -> a tensor that owns its memory, bit for bit.

    ``torch.from_numpy`` rejects numpy's bfloat16 extension dtype, so bf16
    arrays go through their uint16 bit pattern. Arrays read back from JAX
    are read-only; the copy gives torch a writable buffer. A 0-dim array
    stays 0-dim (``np.ascontiguousarray`` alone would make it (1,))."""
    a = np.ascontiguousarray(a).reshape(np.shape(a))
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def params_from_numpy(tree):
    """The JAX package's param tree, given as nested dicts of numpy arrays
    (``jax.tree.map(np.asarray, params)``), as the port's tree: same keys,
    same stacked per-layer layout, same bits — MoE expert stacks with
    their int8 / packed int4 codes, scales and zero-points included, and
    the hybrid's ``groups`` / ``shared`` / ``tail`` and the xLSTM's
    ``pairs`` (``m`` / ``s``) trees."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v) for k, v in tree.items()}
    return tensor_from_numpy(np.asarray(tree))
