"""A configuration file's sizes under plain names, read from its published
(Hugging Face ``config.json``) keys. Used by the weights, the reference
and the yardstick; nothing here imports the program."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

QK_NORM_TYPES = ("qwen3", "qwen3_moe")


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


def shapes_of(cfg: dict, name: str = "") -> Shapes:
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
        eps=float(cfg["rms_norm_eps"]),
        qk_norm=cfg.get("model_type") in QK_NORM_TYPES,
        tie=bool(cfg.get("tie_word_embeddings", False)),
        n_experts=int(cfg["num_experts"]) if moe else None,
        top_k=int(cfg["num_experts_per_tok"]) if moe else None,
        dtype=cfg.get("torch_dtype", "bfloat16"))
