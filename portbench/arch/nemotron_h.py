"""Nemotron-H (``model_type`` nemotron_h), NVIDIA's dense hybrid: one
mixer a layer, Mamba-2, a relu^2 MLP or position-free grouped-query
attention, as ``hybrid_override_pattern`` gives them. The configuration's
sizes under plain names, the port's ``ModelConfig``, the weights' leaves,
the plain reference (``reference/nemotron_h.py``) and the analytic step
operations (``roofline/nemotron_h.py``). Nothing here imports the program
but ``port_config``, which builds the port's configuration.

Every leaf is drawn in the served type (bf16), but the scan's ``a_log``,
``dt_bias`` and ``d_skip``, which are f32 as the port serves them. A
matrix is N(0, 1/fan_in), the conv's taps too (fan-in: its width); norm
scales and D are 1 + N(0, 0.05^2); the conv bias is N(0, 0.02^2).
``A_log`` is log U(1, 16) and ``dt_bias`` the inverse softplus of a dt
drawn log-uniform in [``time_step_min``, ``time_step_max``] and floored
at ``time_step_floor``: Mamba-2's published initialisation, so the state
decays as a trained model's does. Those two are drawn as the others are,
N(0, 1), and carried to their law through the normal distribution
function (``Law``).
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from portbench.reference.nemotron_h import Reference
from portbench.roofline.nemotron_h import (head_flops, prompt_flops,
                                           token_flops)

__all__ = ["Shapes", "shapes", "port_config", "leaves", "Reference",
           "prompt_flops", "token_flops", "head_flops", "Law"]


@dataclass(frozen=True)
class Shapes:
    name: str
    n_layers: int
    pattern: str              # hybrid_override_pattern: "M", "-", "*"
    d: int
    n_heads: int
    n_kv: int
    head_dim: int
    d_ff: int                 # the MLP's width
    vocab: int
    eps: float
    m_heads: int              # Mamba-2 heads
    m_head_dim: int
    expand: int
    groups: int               # of B and C
    state: int
    conv: int                 # the conv's width
    conv_bias: bool
    chunk: int                # the scan's published chunk
    dt_min: float
    dt_max: float
    dt_floor: float
    dtype: str = "bfloat16"
    moe: bool = False

    @property
    def d_inner(self) -> int:
        return self.m_heads * self.m_head_dim

    @property
    def conv_channels(self) -> int:
        """x, B and C: the conv's channels."""
        return self.d_inner + 2 * self.groups * self.state


def shapes(cfg: dict, name: str = "") -> Shapes:
    """The sizes of configuration file ``cfg`` (Hugging Face
    ``config.json`` keys); a configuration the port does not run as
    published is refused."""
    refuse = {
        "mlp_hidden_act": ("relu2", "only the relu^2 MLP is run"),
        "mamba_hidden_act": ("silu", "only the SiLU conv activation is run"),
        "attention_bias": (False, "attention biases are not run"),
        "mlp_bias": (False, "MLP biases are not run"),
        "use_bias": (False, "Mamba-2 projection biases are not run"),
        "mamba_proj_bias": (False, "Mamba-2 projection biases are not run"),
        "residual_in_fp32": (False, "an f32 residual is not run"),
        "sliding_window": (None, "sliding-window attention is not run"),
        "tie_word_embeddings": (False, "tied embeddings are not run"),
    }
    for key, (want, why) in refuse.items():
        if cfg.get(key, want) != want:
            raise ValueError(why)
    if list(cfg.get("time_step_limit", [0, None])) != [0, None]:
        raise ValueError("only the unclamped step (time_step_limit (0, "
                         "inf)) is run")
    pattern = cfg["hybrid_override_pattern"]
    if len(pattern) != int(cfg["num_hidden_layers"]) or set(pattern) - \
            set("M-*"):
        raise ValueError("hybrid_override_pattern must give one of M, - "
                         "and * for each layer")
    d, expand = int(cfg["hidden_size"]), int(cfg["expand"])
    heads, hd = int(cfg["mamba_num_heads"]), int(cfg["mamba_head_dim"])
    if heads * hd != expand * d:
        raise ValueError("the Mamba-2 heads must fill expand x hidden_size")
    return Shapes(
        name=name, n_layers=len(pattern), pattern=pattern, d=d,
        n_heads=int(cfg["num_attention_heads"]),
        n_kv=int(cfg["num_key_value_heads"]),
        head_dim=int(cfg["attention_head_dim"]),
        d_ff=int(cfg["intermediate_size"]), vocab=int(cfg["vocab_size"]),
        eps=float(cfg["layer_norm_epsilon"]), m_heads=heads,
        m_head_dim=hd, expand=expand, groups=int(cfg["n_groups"]),
        state=int(cfg["ssm_state_size"]), conv=int(cfg["conv_kernel"]),
        conv_bias=bool(cfg["use_conv_bias"]),
        chunk=int(cfg["chunk_size"]),
        dt_min=float(cfg["time_step_min"]),
        dt_max=float(cfg["time_step_max"]),
        dt_floor=float(cfg["time_step_floor"]),
        dtype=cfg.get("torch_dtype", "bfloat16"))


def port_config(cfg: dict, s: Shapes):
    """The port's ``ModelConfig`` for configuration file ``cfg``."""
    from repro_torch.config import ModelConfig
    return ModelConfig(
        name=s.name, family="hybrid", n_layers=s.n_layers, d_model=s.d,
        n_heads=s.n_heads, n_kv_heads=s.n_kv, d_ff=s.d_ff, vocab=s.vocab,
        head_dim=s.head_dim, mlp="relu2", pos="none",
        ssm_state=s.state, ssm_head_dim=s.m_head_dim, ssm_expand=s.expand,
        ssm_conv=s.conv, ssm_groups=s.groups, ssm_conv_bias=s.conv_bias,
        layer_pattern=s.pattern, tie_embeddings=False, norm_eps=s.eps,
        dtype=s.dtype, source=cfg.get("source", ""))


class Law:
    """A leaf's scale that carries its N(0, 1) draw ``x`` to another law:
    ``quantile(Phi(x))``, with Phi the normal distribution function.
    ``weights.draw_weights`` scales each draw in place by its leaf's
    scale (``x.mul_(std)``); this object takes that call
    (``__torch_function__``) and writes the quantile there instead."""

    def __init__(self, quantile):
        self.quantile = quantile

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        if getattr(func, "__name__", None) != "mul_" or kwargs:
            return NotImplemented
        x, law = args
        return x.copy_(law.quantile(torch.special.ndtr(x)))


def a_log_law() -> Law:
    """A_log = log A, A ~ U(1, 16)."""
    return Law(lambda u: torch.log1p(15 * u))


def dt_bias_law(s: Shapes) -> Law:
    """The inverse softplus of dt, dt log-uniform in [dt_min, dt_max],
    floored at dt_floor."""
    lo, hi = math.log(s.dt_min), math.log(s.dt_max)

    def quantile(u):
        dt = torch.exp(lo + u * (hi - lo)).clamp(min=s.dt_floor)
        return dt + torch.log(-torch.expm1(-dt))
    return Law(quantile)


def leaves(s: Shapes):
    """(path, shape, dtype, std, None for a norm scale, or a ``Law``), in
    drawing order, in the stacked layout the port's ``Session`` takes:
    every layer's pre-norm in one (L, d) leaf, and each mixer kind's
    leaves with a leading axis over the layers of that kind."""
    bf, f32 = getattr(torch, s.dtype), torch.float32
    d, di, C, H = s.d, s.d_inner, s.conv_channels, s.m_heads
    nM, nF, nA = (s.pattern.count(k) for k in "M-*")
    hd = s.head_dim
    out = [(("embed",), (s.vocab, d), bf, 1 / math.sqrt(d)),
           (("final_norm",), (d,), bf, None),
           (("layers", "ln"), (s.n_layers, d), bf, None)]
    if nM:
        out += [(("layers", "mamba", "w_in"), (nM, d, di + C + H), bf,
                 1 / math.sqrt(d)),
                (("layers", "mamba", "conv_w"), (nM, s.conv, C), bf,
                 1 / math.sqrt(s.conv))]
        if s.conv_bias:
            out.append((("layers", "mamba", "conv_b"), (nM, C), bf, 0.02))
        out += [(("layers", "mamba", "a_log"), (nM, H), f32, a_log_law()),
                (("layers", "mamba", "dt_bias"), (nM, H), f32,
                 dt_bias_law(s)),
                (("layers", "mamba", "d_skip"), (nM, H), f32, None),
                (("layers", "mamba", "gate_norm"), (nM, di), bf, None),
                (("layers", "mamba", "w_out"), (nM, di, d), bf,
                 1 / math.sqrt(di))]
    if nF:
        out += [(("layers", "ffn", "w_up"), (nF, d, s.d_ff), bf,
                 1 / math.sqrt(d)),
                (("layers", "ffn", "w_down"), (nF, s.d_ff, d), bf,
                 1 / math.sqrt(s.d_ff))]
    if nA:
        out += [(("layers", "attn", "wq"), (nA, d, s.n_heads * hd), bf,
                 1 / math.sqrt(d)),
                (("layers", "attn", "wk"), (nA, d, s.n_kv * hd), bf,
                 1 / math.sqrt(d)),
                (("layers", "attn", "wv"), (nA, d, s.n_kv * hd), bf,
                 1 / math.sqrt(d)),
                (("layers", "attn", "wo"), (nA, s.n_heads * hd, d), bf,
                 1 / math.sqrt(s.n_heads * hd))]
    out.append((("unembed",), (d, s.vocab), bf, 1 / math.sqrt(d)))
    return out
