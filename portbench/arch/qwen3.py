"""Qwen3 decoders, dense (``model_type`` qwen3) and MoE (qwen3_moe;
``arch/qwen3_moe.py`` names this file): the configuration's sizes under
plain names, the port's ``ModelConfig``, the weights' leaves, the plain
reference (``reference/qwen3.py``) and the analytic step operations
(``roofline/work.py``). Nothing here imports the program but
``port_config``, which builds the port's configuration.

Every leaf is drawn in the served type (bf16), the MoE router in f32 as
the port serves it.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch

from portbench.reference.qwen3 import Reference
from portbench.roofline.work import head_flops, prompt_flops, token_flops

__all__ = ["Shapes", "shapes", "port_config", "leaves", "Reference",
           "prompt_flops", "token_flops", "head_flops"]


@dataclass(frozen=True)
class Shapes:
    name: str
    n_layers: int
    d: int
    n_heads: int
    n_kv: int
    head_dim: int
    d_ff: int                 # dense FFN width, or one expert's width
    vocab: int
    rope_theta: float
    eps: float
    qk_norm: bool
    tie: bool
    n_experts: Optional[int] = None
    top_k: Optional[int] = None
    dtype: str = "bfloat16"

    @property
    def moe(self) -> bool:
        return self.n_experts is not None


def shapes(cfg: dict, name: str = "") -> Shapes:
    """The sizes of configuration file ``cfg`` (Hugging Face
    ``config.json`` keys); a configuration the port does not run as
    published is refused."""
    if cfg.get("hidden_act", "silu") != "silu":
        raise ValueError("only SwiGLU (hidden_act silu) decoders are run")
    if cfg.get("attention_bias"):
        raise ValueError("attention biases are not run")
    if cfg.get("use_sliding_window"):
        raise ValueError("sliding-window attention is not run")
    if cfg.get("rope_scaling"):
        raise ValueError("rope scaling is not run")
    moe = "num_experts" in cfg
    if moe:
        if not cfg.get("norm_topk_prob", False):
            raise ValueError("the port renormalises the top-k gates; a "
                             "configuration with norm_topk_prob false is "
                             "not run")
        if cfg.get("decoder_sparse_step", 1) != 1 or cfg.get("mlp_only_layers"):
            raise ValueError("every layer must be an MoE layer")
    return Shapes(
        name=name, n_layers=int(cfg["num_hidden_layers"]),
        d=int(cfg["hidden_size"]), n_heads=int(cfg["num_attention_heads"]),
        n_kv=int(cfg["num_key_value_heads"]),
        head_dim=int(cfg.get("head_dim") or
                     cfg["hidden_size"] // cfg["num_attention_heads"]),
        d_ff=int(cfg["moe_intermediate_size"] if moe
                 else cfg["intermediate_size"]),
        vocab=int(cfg["vocab_size"]), rope_theta=float(cfg["rope_theta"]),
        eps=float(cfg["rms_norm_eps"]), qk_norm=True,
        tie=bool(cfg.get("tie_word_embeddings", False)),
        n_experts=int(cfg["num_experts"]) if moe else None,
        top_k=int(cfg["num_experts_per_tok"]) if moe else None,
        dtype=cfg.get("torch_dtype", "bfloat16"))


def port_config(cfg: dict, s: Shapes):
    """The port's ``ModelConfig`` for configuration file ``cfg``."""
    from repro_torch.config import ModelConfig, MoEConfig
    moe = None
    if s.moe:
        # dropless: capacity factor E / k gives capacity = the chunk's
        # tokens at every chunk size (models/mlp.py::capacity_of)
        moe = MoEConfig(n_experts=s.n_experts, top_k=s.top_k,
                        d_expert=s.d_ff,
                        capacity_factor=s.n_experts / s.top_k,
                        router_dtype="float32")
    return ModelConfig(
        name=s.name, family="moe" if s.moe else "dense",
        n_layers=s.n_layers, d_model=s.d, n_heads=s.n_heads,
        n_kv_heads=s.n_kv, d_ff=s.d_ff, vocab=s.vocab, head_dim=s.head_dim,
        qk_norm=s.qk_norm, mlp="swiglu", pos="rope",
        rope_theta=s.rope_theta, moe=moe, tie_embeddings=s.tie,
        norm_eps=s.eps, dtype=s.dtype, source=cfg.get("source", ""))


def leaves(s: Shapes):
    """(path, shape, dtype, std or None for a norm scale), in drawing
    order, in the stacked layout the port's ``Session`` takes: each
    per-layer leaf has a leading layer axis."""
    L, d, hd = s.n_layers, s.d, s.head_dim
    bf, f32 = getattr(torch, s.dtype), torch.float32
    out = [(("embed",), (s.vocab, d), bf, 1 / math.sqrt(d)),
           (("final_norm",), (d,), bf, None),
           (("layers", "ln1"), (L, d), bf, None),
           (("layers", "ln2"), (L, d), bf, None),
           (("layers", "attn", "wq"), (L, d, s.n_heads * hd), bf,
            1 / math.sqrt(d)),
           (("layers", "attn", "wk"), (L, d, s.n_kv * hd), bf,
            1 / math.sqrt(d)),
           (("layers", "attn", "wv"), (L, d, s.n_kv * hd), bf,
            1 / math.sqrt(d)),
           (("layers", "attn", "wo"), (L, s.n_heads * hd, d), bf,
            1 / math.sqrt(s.n_heads * hd))]
    if s.qk_norm:
        out += [(("layers", "attn", "q_norm"), (L, hd), bf, None),
                (("layers", "attn", "k_norm"), (L, hd), bf, None)]
    if not s.tie:
        out.append((("unembed",), (d, s.vocab), bf, 1 / math.sqrt(d)))
    if s.moe:
        E, f = s.n_experts, s.d_ff
        out += [(("layers", "moe", "router"), (L, d, E), f32,
                 1 / math.sqrt(d)),
                (("layers", "moe", "w_gate"), (L, E, d, f), bf,
                 1 / math.sqrt(d)),
                (("layers", "moe", "w_up"), (L, E, d, f), bf,
                 1 / math.sqrt(d)),
                (("layers", "moe", "w_down"), (L, E, f, d), bf,
                 1 / math.sqrt(f))]
    else:
        f = s.d_ff
        out += [(("layers", "ffn", "w_gate"), (L, d, f), bf,
                 1 / math.sqrt(d)),
                (("layers", "ffn", "w_up"), (L, d, f), bf, 1 / math.sqrt(d)),
                (("layers", "ffn", "w_down"), (L, f, d), bf,
                 1 / math.sqrt(f))]
    return out
