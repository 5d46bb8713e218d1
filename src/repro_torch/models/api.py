"""Public model API: ``build_model(cfg)`` -> Model with init/apply/loss, the
masked LM ``cross_entropy``, the bridge that carries the JAX package's
parameters (as numpy) into the port, and the specs a count runs on
(``param_specs``, ``input_specs``, ``cache_specs``).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
from torch._guards import detect_fake_mode
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.config import ModelConfig, ShapeConfig
from repro_torch.models import hybrid, transformer, xlstm
from repro_torch.models.common import tree_map

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


# ---------------------------------------------------------------- specs
_SPEC_MODE = None


def spec_mode() -> FakeTensorMode:
    """The fake tensor mode the specs are made in: the one active, else
    one shared by every spec this process makes (tensors of two fake modes
    cannot meet in one op)."""
    global _SPEC_MODE
    mode = detect_fake_mode()
    if mode is not None:
        return mode
    if _SPEC_MODE is None:
        _SPEC_MODE = FakeTensorMode()
    return _SPEC_MODE


def param_specs(cfg: ModelConfig, device="cuda"):
    """The param tree of ``cfg`` as fake tensors on ``device`` (shapes,
    dtypes, no storage), on a card or not. Built by ``init_params`` itself
    under ``spec_mode()``, on a CPU generator: in the mode every draw,
    quantisation and stack is a fake tensor, so nothing is allocated and
    the tree is the one a real init makes, quantised leaves included,
    without a second description of it; the leaves then take ``device``
    (fake tensors of the same shapes and dtypes: a CPU-only build cannot
    copy a fake tensor to a CUDA device, but it can make one there)."""
    device = torch.device(device)
    with spec_mode():
        params = build_model(cfg).init(torch.Generator().manual_seed(0))
        if device.type != "cpu":
            params = tree_map(lambda t: torch.empty(
                t.shape, dtype=t.dtype, device=device), params)
    return params


def cache_specs(cfg: ModelConfig, batch, max_seq, device="cuda"):
    """The serving cache of ``cfg`` for ``batch`` sequences of up to
    ``max_seq`` tokens as fake tensors on ``device``: ``init_cache``
    under ``spec_mode()``."""
    with spec_mode():
        return build_model(cfg).init_cache(batch, max_seq, device=device)


def input_specs(cfg: ModelConfig, shape: ShapeConfig, device="cuda") -> dict:
    """Fake tensors on ``device`` for every input of the step this
    (arch, shape) cell runs, as the reference's ``input_specs``: train
    ``{"batch"}``, prefill ``{"batch", "cache"}``, decode ``{"batch",
    "cache", "pos"}``; int32 tokens and labels ((B, S, nq) for the audio
    family); the vlm family's ``vision_embeds`` (bf16, in front of S - nv
    tokens), 3D ``positions`` and ``loss_mask``; decode one token against
    a cache of S, at a 0-dim int32 ``pos`` (``launch/dryrun.py`` reads the
    position as the int the port's decode takes)."""
    B, S = shape.global_batch, shape.seq_len
    i32, bf16 = torch.int32, torch.bfloat16

    def t(shp, dtype):
        return torch.empty(shp, dtype=dtype, device=device)
    with spec_mode():
        tok = (B, S, cfg.n_codebooks) if cfg.n_codebooks else (B, S)
        if shape.kind == "decode":
            batch = {"tokens": t((B, 1, cfg.n_codebooks) if cfg.n_codebooks
                                 else (B, 1), i32)}
            if cfg.family == "vlm":
                batch["positions"] = t((3, B, 1), i32)
            return {"batch": batch,
                    "cache": cache_specs(cfg, B, S, device),
                    "pos": t((), i32)}
        if cfg.family == "vlm":
            nv = cfg.n_vision_tokens
            batch = {"tokens": t((B, S - nv), i32),
                     "vision_embeds": t((B, nv, cfg.d_model), bf16),
                     "positions": t((3, B, S), i32)}
            if shape.kind == "train":
                batch.update(labels=t((B, S), i32),
                             loss_mask=t((B, S), torch.float32))
        else:
            batch = {"tokens": t(tok, i32)}
            if shape.kind == "train":
                batch["labels"] = t(tok, i32)
        if shape.kind == "train":
            return {"batch": batch}
        return {"batch": batch, "cache": cache_specs(cfg, B, S, device)}
