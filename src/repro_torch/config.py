"""Config system: model/shape dataclasses and the architecture registry.

Every assigned architecture lives in ``repro/configs/<id>.py`` exposing
``full()`` (the exact published config) and ``smoke()`` (a reduced same-family
config for CPU tests). Shapes are global (LM-family shape card).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_expert: int
    capacity_factor: float = 1.25
    router_dtype: str = "float32"


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | vlm | audio | hybrid | ssm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None  # None -> d_model // n_heads
    qk_norm: bool = False           # qwen3: rmsnorm on q,k per head
    qkv_bias: bool = False          # qwen2: bias on qkv projections
    mlp: str = "swiglu"             # swiglu | gelu
    pos: str = "rope"               # rope | mrope | sin | none
    rope_theta: float = 1_000_000.0
    moe: Optional[MoEConfig] = None
    # State-space (mamba2) parameters for hybrid/ssm families.
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv: int = 4
    # zamba2: one shared transformer block applied after every N ssm layers.
    shared_attn_every: int = 0
    # musicgen: number of EnCodec codebooks (parallel output heads).
    n_codebooks: int = 0
    # vlm: number of vision-embedding positions prepended by the stub frontend.
    n_vision_tokens: int = 0
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"
    # beyond-paper serving mode: experts stored int8 + per-expert scales
    # (halves the dominant HBM term of MoE decode; EXPERIMENTS.md §Perf C2)
    expert_quant: str = "none"  # none | int8
    # streamed-weight quantisation for ALL streamable shard kinds (dense FFN
    # and MoE experts): grouped int8 or packed int4 with per-group scales /
    # zero-points, dequant fused into the streamed matmul (DESIGN.md §11).
    # "fp16" keeps weights at the compute dtype — bit-exact baseline.
    weight_quant: str = "fp16"  # fp16 | int8 | int4
    # tokenizer identity (e.g. "qwen2"): None = unknown. Speculative
    # decoding compares draft/target token ids, so Session.open raises
    # when BOTH models declare a tokenizer and they differ — equal vocab
    # sizes alone do not make the id spaces compatible (DESIGN.md §14)
    tokenizer: Optional[str] = None
    # citation tag from the assignment card
    source: str = ""

    def __post_init__(self):
        if self.weight_quant not in ("fp16", "int8", "int4"):
            raise ValueError(
                f"weight_quant must be fp16 | int8 | int4, "
                f"got {self.weight_quant!r}")
        if self.expert_quant not in ("none", "int8"):
            raise ValueError(
                f"expert_quant must be none | int8, got {self.expert_quant!r}")
        if self.weight_quant != "fp16" and self.expert_quant != "none":
            raise ValueError(
                "weight_quant already covers expert shards; combining it "
                "with expert_quant is ambiguous — pick one")

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.n_heads

    @property
    def d_inner(self) -> int:
        """Mamba2 inner width."""
        return self.ssm_expand * self.d_model

    @property
    def n_ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # ---- analytic parameter counts (used by planner + roofline) ----
    def param_count(self) -> int:
        d, hd = self.d_model, self.resolved_head_dim
        qdim, kvdim = self.n_heads * hd, self.n_kv_heads * hd
        attn = d * qdim + 2 * d * kvdim + qdim * d  # q,k,v,o
        if self.mlp == "swiglu":
            ffn_dense = 3 * d * self.d_ff
        else:
            ffn_dense = 2 * d * self.d_ff
        per_layer = 0
        if self.family in ("dense", "vlm", "audio", "moe"):
            per_layer = attn + 2 * d  # norms
            if self.moe is not None:
                per_layer += d * self.moe.n_experts  # router
                per_layer += self.moe.n_experts * 3 * d * self.moe.d_expert
            else:
                per_layer += ffn_dense
            total = self.n_layers * per_layer
        elif self.family == "hybrid":
            total = self.n_layers * self._mamba_params()
            if self.shared_attn_every:
                total += attn + ffn_dense + 2 * d  # single shared block
        elif self.family == "ssm":
            # alternating mLSTM / sLSTM blocks
            total = self.n_layers * self._xlstm_params()
        else:
            raise ValueError(self.family)
        emb = self.vocab * d
        heads = max(1, self.n_codebooks or 1)
        out = 0 if self.tie_embeddings else heads * self.vocab * d
        if self.n_codebooks:
            emb = self.n_codebooks * self.vocab * d
        return total + emb + out + d  # final norm

    def _mamba_params(self) -> int:
        d, di, n = self.d_model, self.d_inner, self.ssm_state
        h = self.n_ssm_heads
        in_proj = d * (2 * di + 2 * n + h)   # x, z, B, C, dt
        conv = self.ssm_conv * (di + 2 * n)
        out_proj = di * d
        return in_proj + conv + out_proj + 2 * h + d  # A, D, norm

    def _xlstm_params(self) -> int:
        d = self.d_model
        # mLSTM block: up-proj x2, q/k/v, gates, down-proj (approx public cfg)
        di = 2 * d
        m = d * 2 * di + 3 * di * di // 4 + di * d + 2 * d
        # sLSTM block: 4 gates r+w + ffn(4/3)
        s = 8 * d * d + 2 * int(d * 4 / 3) * d + 2 * d
        return (m + s) // 2


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    kind: str  # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeConfig("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524288, 1),
}

# Archs allowed to run long_500k (sub-quadratic decode); see DESIGN.md §5.
LONG_CONTEXT_ARCHS = ("zamba2-7b", "xlstm-125m")


def cells():
    """All graded (arch, shape) dry-run cells, with skip rules applied."""
    from repro_torch.configs import list_archs
    out = []
    for arch in list_archs():
        for sname in ("train_4k", "prefill_32k", "decode_32k", "long_500k"):
            if sname == "long_500k" and arch not in LONG_CONTEXT_ARCHS:
                continue
            out.append((arch, sname))
    return out
