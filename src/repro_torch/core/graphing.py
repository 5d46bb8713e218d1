"""Build the sub-layer graph of a ModelConfig (paper: ShardIntoSubLayers).

``shard_div`` divides weight/KV sizes for pod-scale use: when the model is
already TP/EP-sharded across a mesh, the planner sees the per-chip slice
(client mode: div=1 everywhere).

A hybrid with a ``layer_pattern`` (nemotron-h) has one mixer a layer:
``L{i}/mamba`` with its per-slot ``L{i}/state`` (conv and SSM state, f32
SSM), ``L{i}/ffn``, or ``L{i}/attn`` with ``L{i}/kv``; zamba2 (no pattern)
has a mamba sub-layer every layer and the shared block's every
``shared_attn_every``.

``expert_granular=True`` splits every MoE FFN below the sub-layer level
(DESIGN.md §9): a ``L{i}/moe.router`` shard (fp32 router weights, pinned
with attention priority) plus ``n_experts`` individually placeable
``L{i}/moe.expert{e}`` shards. ``routing`` seeds each expert's selection
frequency (``meta["hot"]``) from profile-DB routing stats so the planner
pins the hot set first; absent stats default to uniform ``1/E``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

from repro_torch.config import ModelConfig
from repro_torch.core.sublayer import SubLayer
from repro_torch.kernels.streamed_matmul import GROUP_SIZE


@dataclass(frozen=True)
class ShardDiv:
    attn: int = 1
    ffn: int = 1
    kv: int = 1
    out: int = 1


def _grouped_bytes(K: int, N: int, quant: str, group: int = GROUP_SIZE) -> int:
    """Exact on-the-wire bytes of one (K, N) matrix under ``weight_quant``:
    payload plus per-group metadata, mirroring kernels/streamed_matmul.py
    (G = ceil(K / group) balanced groups; int8 carries fp32 scales, int4
    packs two codes per byte with fp16 scales + uint8 zero-points)."""
    G = -(-K // group)
    if quant == "int8":
        return K * N + G * N * 4
    if quant == "int4":
        return (K // 2) * N + G * N * 2 + G * N
    raise ValueError(quant)


def ffn_weight_bytes(cfg: ModelConfig, wdtype):
    """Bytes of ONE dense FFN's weight stack as the executor moves it.
    fp16 keeps the seed's ``n_mat * d * f * wdtype`` (float-preserving for
    the benchmarks' fractional wdtypes); quantised modes price the
    ``n_mat - 1`` up-projections (d, f) and the (f, d) down-projection at
    their packed size + scale/zero metadata (DESIGN.md §11)."""
    d, f = cfg.d_model, cfg.d_ff
    n_mat = 3 if cfg.mlp == "swiglu" else 2
    if cfg.weight_quant == "fp16":
        return n_mat * d * f * wdtype
    return ((n_mat - 1) * _grouped_bytes(d, f, cfg.weight_quant)
            + _grouped_bytes(f, d, cfg.weight_quant))


def expert_weight_bytes(cfg: ModelConfig, wdtype) -> int:
    """Bytes of ONE expert's weight stack as the executor actually moves
    it. ``expert_quant == "int8"`` stores the three (d, f) matrices int8
    plus three (1, 1) fp32 scales (models/mlp.py), so the per-expert
    transfer is ``3*d*f + 12`` bytes — NOT the bf16 ``3*d*f*2`` the seed
    accounting assumed. ``weight_quant`` prices the grouped int8 / packed
    int4 layout per matrix (DESIGN.md §11)."""
    m = cfg.moe
    d, f = cfg.d_model, m.d_expert
    if cfg.expert_quant == "int8":
        return 3 * d * f + 3 * 4
    if cfg.weight_quant != "fp16":
        return (2 * _grouped_bytes(d, f, cfg.weight_quant)
                + _grouped_bytes(f, d, cfg.weight_quant))
    return int(3 * d * f * wdtype)


def _ffn_sub(cfg: ModelConfig, layer: int, wdtype, div: ShardDiv,
             name: str, w=None, **meta) -> SubLayer:
    n_mat = 3 if cfg.mlp == "swiglu" else 2
    f_wdt = {"int8": 1, "int4": 0.5}.get(cfg.weight_quant, wdtype)
    if w is None:
        w = ffn_weight_bytes(cfg, wdtype) // div.ffn
    return SubLayer(name, "ffn", layer, w,
                    meta={"d": cfg.d_model, "f": cfg.d_ff, "n_mat": n_mat,
                          "wdtype": f_wdt, "quant": cfg.weight_quant,
                          **meta})


def _mamba_sub(cfg: ModelConfig, layer: int, wdtype, div: ShardDiv):
    """A Mamba-2 mixer: its in- and out-projections' bytes (B and C per
    group); ``meta["g"]`` where there is more than one group."""
    d, di, n = cfg.d_model, cfg.d_inner, cfg.ssm_state
    gn = cfg.ssm_groups * n
    w = (d * (2 * di + 2 * gn + cfg.n_ssm_heads) + di * d) * wdtype // div.ffn
    meta = {"d": d, "di": di, "n": max(n, 1), "h": cfg.n_ssm_heads,
            "p": cfg.ssm_head_dim, "wdtype": wdtype}
    if cfg.ssm_groups != 1:
        meta["g"] = cfg.ssm_groups
    return SubLayer(f"L{layer}/mamba", "mamba", layer, w, meta=meta)


def _state_bytes_per_slot(cfg: ModelConfig) -> int:
    """One slot's state of one Mamba-2 layer as the executor holds it:
    the conv history in bf16 and the SSM state in f32."""
    conv = (cfg.ssm_conv - 1) * (cfg.d_inner
                                 + 2 * cfg.ssm_groups * cfg.ssm_state)
    return conv * 2 + cfg.n_ssm_heads * cfg.ssm_head_dim * cfg.ssm_state * 4


def build_graph(cfg: ModelConfig, wdtype: int = 2,
                div: ShardDiv = ShardDiv(), *,
                expert_granular: bool = False,
                routing: Optional[Dict[int, Sequence[float]]] = None,
                ) -> List[SubLayer]:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    H, KV = cfg.n_heads, cfg.n_kv_heads
    subs: List[SubLayer] = []
    subs.append(SubLayer("embed", "embed", -1,
                         cfg.vocab * d * wdtype // max(div.out, 1),
                         meta={"d": d, "wdtype": wdtype}))
    attn_w = (d * H * hd + 2 * d * KV * hd + H * hd * d) * wdtype // div.attn
    kv_per_tok = 2 * KV * hd * 2 // div.kv  # bf16 cache
    first_shared = True
    for layer in range(cfg.n_layers):
        kind = cfg.layer_pattern[layer] if cfg.layer_pattern else None
        if kind == "M":
            state = _state_bytes_per_slot(cfg) // div.kv
            subs.append(_mamba_sub(cfg, layer, wdtype, div))
            subs.append(SubLayer(f"L{layer}/state", "state", layer, 0,
                                 meta={"bytes_per_slot": state}))
            continue
        if kind == "-":
            subs.append(_ffn_sub(cfg, layer, wdtype, div, f"L{layer}/ffn"))
            continue
        if kind == "*":
            subs.append(SubLayer(f"L{layer}/attn", "attn", layer, attn_w,
                                 meta={"d": d, "H": H, "KV": KV, "hd": hd,
                                       "wdtype": wdtype}))
            subs.append(SubLayer(f"L{layer}/kv", "kv", layer, 0,
                                 kv_bytes_per_token=kv_per_tok))
            continue
        is_mamba = cfg.family in ("hybrid", "ssm")
        shared_here = (cfg.shared_attn_every > 0
                       and (layer + 1) % cfg.shared_attn_every == 0)
        if not is_mamba:
            subs.append(SubLayer(f"L{layer}/attn", "attn", layer, attn_w,
                                 meta={"d": d, "H": H, "KV": KV, "hd": hd,
                                       "wdtype": wdtype}))
            subs.append(SubLayer(f"L{layer}/kv", "kv", layer, 0,
                                 kv_bytes_per_token=kv_per_tok))
            if cfg.moe is not None:
                m = cfg.moe
                e_w = expert_weight_bytes(cfg, wdtype) // div.ffn
                e_quant = ("int8" if cfg.expert_quant == "int8"
                           else cfg.weight_quant)
                e_wdt = {"int8": 1, "int4": 0.5}.get(e_quant, wdtype)
                if expert_granular:
                    freqs = (routing or {}).get(layer)
                    subs.append(SubLayer(
                        f"L{layer}/moe.router", "moe_router", layer,
                        d * m.n_experts * 4,
                        meta={"d": d, "E": m.n_experts, "top_k": m.top_k,
                              "wdtype": wdtype}))
                    for e in range(m.n_experts):
                        hot = (float(freqs[e]) if freqs is not None
                               else 1.0 / m.n_experts)
                        subs.append(SubLayer(
                            f"L{layer}/moe.expert{e}", "moe_expert", layer,
                            e_w,
                            meta={"d": d, "f": m.d_expert, "E": m.n_experts,
                                  "top_k": m.top_k, "expert": e, "hot": hot,
                                  "wdtype": e_wdt, "quant": e_quant}))
                else:
                    subs.append(SubLayer(
                        f"L{layer}/moe", "moe", layer, m.n_experts * e_w,
                        meta={"d": d, "f": m.d_expert,
                              "E": m.n_experts, "top_k": m.top_k,
                              "wdtype": e_wdt, "quant": e_quant}))
            else:
                subs.append(_ffn_sub(cfg, layer, wdtype, div,
                                     f"L{layer}/ffn"))
        else:
            subs.append(_mamba_sub(cfg, layer, wdtype, div))
            if shared_here:
                # one set of shared weights (counted once); per-application KV
                w_attn = attn_w if first_shared else 0
                w_ffn = (ffn_weight_bytes(cfg, wdtype) // div.ffn) \
                    if first_shared else 0
                first_shared = False
                subs.append(SubLayer(f"L{layer}/shared_attn", "attn", layer,
                                     w_attn,
                                     meta={"d": d, "H": H, "KV": KV, "hd": hd,
                                           "wdtype": wdtype, "shared": True}))
                subs.append(SubLayer(f"L{layer}/shared_kv", "kv", layer, 0,
                                     kv_bytes_per_token=kv_per_tok))
                subs.append(_ffn_sub(cfg, layer, wdtype, div,
                                     f"L{layer}/shared_ffn", w=w_ffn,
                                     shared=True))
    heads = max(1, cfg.n_codebooks or 1)
    subs.append(SubLayer("outs/head", "out", cfg.n_layers,
                         heads * d * cfg.vocab * wdtype // max(div.out, 1),
                         meta={"d": d, "V": cfg.vocab * heads, "wdtype": wdtype}))
    return subs


def total_weight_bytes(subs) -> int:
    return sum(s.weight_bytes for s in subs)


def total_kv_bytes(subs, setting) -> int:
    return sum(s.bytes_resident(setting) for s in subs if s.kind == "kv")
