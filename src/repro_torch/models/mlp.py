"""Dense FFN sub-layer (swiglu / gelu), with grouped int8 / packed int4
weight quantisation (``cfg.weight_quant``).

MoE is a later slice of the port; stacked expert weights raise here rather
than run something else."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.streamed_matmul import (GROUP_SIZE, dequant_int4,
                                                 dequant_int8, quantize_int4,
                                                 quantize_int8)
from repro_torch.models.common import dense_init


# ----------------------------------------------------- weight quantisation
def quantize_weight_tree(p, weight_quant):
    """Quantise every 2-D ``w_*`` matrix in a param dict at install time.
    Adds ``s_*`` scales (and ``z_*`` zero-points for int4) next to each
    quantised ``w_*``: int8 codes with (G, 1, N) f32 scales, or packed int4
    codes with (G, N) fp16 scales and uint8 zeros."""
    if weight_quant == "fp16":
        return p
    out = dict(p)
    for k in list(p):
        if not k.startswith("w_"):
            continue
        w = p[k]
        if w.ndim != 2:
            raise NotImplementedError(
                f"quantising stacked {tuple(w.shape)} expert weights lands "
                "with the MoE slice of the port")
        if weight_quant == "int8":
            out[k], out[f"s_{k[2:]}"] = quantize_int8(w, block_k=GROUP_SIZE)
        else:
            out[k], out[f"s_{k[2:]}"], out[f"z_{k[2:]}"] = quantize_int4(w)
    return out


def _dequant(params, name, compute_dtype=torch.bfloat16):
    """``params[name]`` as a ``compute_dtype`` matrix: packed int4 and
    grouped int8 dequantised, float weights as they are."""
    w = params[name]
    if w.dtype == torch.uint8:  # packed int4 + per-group scale/zero
        return dequant_int4(w, params[f"s_{name[2:]}"],
                            params[f"z_{name[2:]}"]).to(compute_dtype)
    if w.dtype == torch.int8:
        s = params[f"s_{name[2:]}"]
        if s.ndim == w.ndim + 1:  # grouped along K (weight_quant="int8")
            return dequant_int8(w, s).to(compute_dtype)
        raise NotImplementedError(
            "per-expert int8 weights (expert_quant) land with the MoE slice "
            "of the port")
    return w


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


def activate(cfg, gate, up):
    """The FFN hidden: silu(gate) * up (swiglu) or gelu(up), the tanh
    approximation as jax.nn.gelu's default. silu is written op for op as
    the reference lowers it, x * (1 / (1 + exp(-x))), so bf16 rounds after
    each op exactly as it does there."""
    if cfg.mlp == "swiglu":
        return gate * (1 / (1 + torch.exp(-gate))) * up
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
