"""Dense FFN sub-layer (swiglu / gelu).

MoE and weight quantisation are later slices of the port; their configs
raise here rather than run something else."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.common import dense_init


def init_ffn_params(gen, cfg, dtype, d_ff=None):
    if cfg.weight_quant != "fp16":
        raise NotImplementedError(
            f"weight_quant={cfg.weight_quant!r} lands with the quantised "
            "streaming slice of the port")
    d = cfg.d_model
    f = d_ff or cfg.d_ff
    if cfg.mlp == "swiglu":
        return {
            "w_gate": dense_init(gen, (d, f), 0, dtype),
            "w_up": dense_init(gen, (d, f), 0, dtype),
            "w_down": dense_init(gen, (f, d), 0, dtype),
        }
    return {
        "w_up": dense_init(gen, (d, f), 0, dtype),
        "w_down": dense_init(gen, (f, d), 0, dtype),
    }


def activate(cfg, gate, up):
    """The FFN hidden: silu(gate) * up (swiglu) or gelu(up), the tanh
    approximation as jax.nn.gelu's default. silu is written op for op as
    the reference lowers it, x * (1 / (1 + exp(-x))), so bf16 rounds after
    each op exactly as it does there."""
    if cfg.mlp == "swiglu":
        return gate * (1 / (1 + torch.exp(-gate))) * up
    return F.gelu(up, approximate="tanh")


def ffn(params, cfg, x):
    if cfg.mlp == "swiglu":
        h = activate(cfg, x @ params["w_gate"], x @ params["w_up"])
    else:
        h = activate(cfg, None, x @ params["w_up"])
    return h @ params["w_down"]
