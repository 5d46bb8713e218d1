"""Sub-layer shard IR — the paper's scheduling unit.

A model decomposes into sub-layers at attention/FFN boundaries ("arithmetic
intensity changes there" — Lessons Learned). Each sub-layer knows its weight
bytes, its KV bytes, and how to enumerate its constituent *kernels* for a
given (new_tokens, context) point, which is what the profile-driven cost
model consumes.

Priority order for VRAM pinning (paper §4): attn > kv > ffn > outs.

Below the sub-layer level, an MoE FFN decomposes into addressable shards
(DESIGN.md §9): one ``moe_router`` shard (tiny, priority-pinned with the
attention weights so routing never waits on the link) and ``n_experts``
``moe_expert`` shards that the planner places *individually* — hot experts
pinned, cold ones demand-streamed per decode step.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Tuple

PRIORITY = {"attn": 0, "kv": 1, "mamba": 2, "ffn": 2, "moe": 2, "out": 3,
            "embed": 3, "vision": 1, "moe_router": 0, "moe_expert": 2,
            # paged-KV block restores (DESIGN.md §12): synthetic demand-only
            # shards the executor fabricates per fault — never planned, so
            # they share the kv pin priority but stay out of STREAMABLE_KINDS
            "kv_page": 1}

# Kinds the executor can stream into the VRAM scratch (weights copied
# just-in-time). Everything else is either resident-by-construction (embed,
# out, vision at smoke scale) or has no weights (kv). The prefetch
# double-buffer is sized from the largest sub-layer of THESE kinds — after
# the expert split the unit shrinks from a whole MoE FFN to one expert.
STREAMABLE_KINDS = ("attn", "ffn", "moe", "mamba", "moe_router",
                    "moe_expert")


@dataclass(frozen=True)
class Kernel:
    """One profiled tensor-op invocation."""
    op: str                 # matmul | gqa | mha | moe_route | elementwise
    dims: Tuple[int, ...]   # op-specific (matmul: M,N,K; gqa: t,ctx,H,KV,hd)
    flops: float
    bytes: float            # memory traffic (weights + acts), fast-tier view
    dtype_bytes: int = 2


@dataclass
class SubLayer:
    name: str
    kind: str               # attn | kv | ffn | moe | mamba | out | embed | vision
    layer: int
    weight_bytes: int
    kv_bytes_per_token: int = 0   # kind == "kv": context-proportional size
    meta: dict = field(default_factory=dict)

    @property
    def priority(self) -> int:
        return PRIORITY[self.kind]

    def bytes_resident(self, setting) -> int:
        """Bytes this sub-layer wants resident in the fast tier."""
        if self.kind == "kv":
            return self.kv_bytes_per_token * setting.context * setting.batch
        return self.weight_bytes

    # ------------------------------------------------------------ kernels
    def kernels(self, new_tokens: int, context: int, batch: int) -> List[Kernel]:
        m = self.meta
        t = new_tokens
        wb = m.get("wdtype", 2)
        # profile-lookup dtype for weight-dominated kernels (q4/q2 models
        # stream fewer bytes AND use the quantised kernel entries)
        wdt = 1 if wb < 2 else int(min(4, wb))
        if self.kind == "attn":
            d, H, KV, hd = m["d"], m["H"], m["KV"], m["hd"]
            qkv_n = (H + 2 * KV) * hd
            ks = [
                Kernel("matmul", (t, qkv_n, d), 2.0 * t * qkv_n * d,
                       t * d * 2 + d * qkv_n * wb + t * qkv_n * 2, wdt),
                Kernel("gqa" if KV < H else "mha", (t, context, H, KV, hd),
                       2.0 * batch * H * hd * t * context * 2,
                       batch * (2 * KV * context * hd + 2 * t * H * hd) * 2),
                Kernel("matmul", (t, d, H * hd), 2.0 * t * d * H * hd,
                       t * H * hd * 2 + H * hd * d * wb + t * d * 2, wdt),
                Kernel("elementwise", (t, d), 8.0 * t * d, 4.0 * t * d),
            ]
            return ks
        if self.kind == "ffn":
            d, f, n_mat = m["d"], m["f"], m.get("n_mat", 3)
            return [
                Kernel("matmul", (t, f, d), 2.0 * t * f * d * (n_mat - 1),
                       (n_mat - 1) * (t * d * 2 + d * f * wb + t * f * 2), wdt),
                Kernel("matmul", (t, d, f), 2.0 * t * d * f,
                       t * f * 2 + f * d * wb + t * d * 2, wdt),
                Kernel("elementwise", (t, f), 6.0 * t * f, 4.0 * t * f),
            ]
        if self.kind == "moe":
            d, f, E, k = m["d"], m["f"], m["E"], m["top_k"]
            tok_per_e = max(1.0, t * k / E)
            return [
                Kernel("moe_route", (t, E), 2.0 * t * E * d / d + 5.0 * t * E,
                       t * d * 2 + d * E * 4),
                # active experts: k selected per token -> t*k expert-token pairs
                Kernel("matmul", (int(tok_per_e), f, d),
                       2.0 * t * k * f * d * 3,
                       min(E, t * k) * 3 * d * f * wb + t * k * (d + f) * 2,
                       wdt),
                Kernel("elementwise", (t, f), 6.0 * t * f, 4.0 * t * f),
            ]
        if self.kind == "moe_router":
            d, E = m["d"], m["E"]
            # same router cost the monolithic moe sub-layer charges
            return [Kernel("moe_route", (t, E), 2.0 * t * E * d / d + 5.0 * t * E,
                           t * d * 2 + d * E * 4)]
        if self.kind == "moe_expert":
            d, f, E, k = m["d"], m["f"], m["E"], m["top_k"]
            # expected token share of THIS expert from its routing frequency
            # (uniform 1/E when no stats are seeded; DESIGN.md §9)
            hot = m.get("hot", 1.0 / E)
            tok = max(1.0, t * k * hot)
            return [
                Kernel("matmul", (int(tok), f, d), 2.0 * tok * f * d * 3,
                       3 * d * f * wb + tok * (d + f) * 2, wdt),
                Kernel("elementwise", (int(tok), f), 6.0 * tok * f,
                       4.0 * tok * f),
            ]
        if self.kind == "mamba":
            d, di, n, h = m["d"], m["di"], m["n"], m["h"]
            conv_ch = di + 2 * n
            return [
                Kernel("matmul", (t, 2 * di + 2 * n + h, d),
                       2.0 * t * (2 * di + 2 * n + h) * d,
                       t * d * 2 + d * (2 * di + 2 * n + h) * wb, wdt),
                # ssd scan ~ 2 matmul-ish passes over state (h, p, n)
                Kernel("elementwise", (t, di),
                       10.0 * t * h * m["p"] * n + 8.0 * t * di,
                       t * di * 4 + h * m["p"] * n * 4),
                Kernel("matmul", (t, d, di), 2.0 * t * d * di,
                       t * di * 2 + di * d * wb + t * d * 2, wdt),
            ]
        if self.kind == "out":
            d, V = m["d"], m["V"]
            return [Kernel("matmul", (t, V, d), 2.0 * t * V * d,
                           t * d * 2 + d * V * wb + t * V * 2, wdt)]
        if self.kind == "embed":
            d = m["d"]
            return [Kernel("elementwise", (t, d), t * d, 3.0 * t * d)]
        if self.kind in ("kv", "kv_page"):
            return []  # no compute; KV bytes ride the attention kernel
        if self.kind == "vision":
            # ViT-ish block cost handled by vlmopt; treat as ffn-like here
            d, f = m["d"], m.get("f", 4 * m["d"])
            nv = m.get("n_vision", 1024)
            return [Kernel("matmul", (nv, f, d), 2.0 * nv * f * d * 2 + 4 * nv * d * d,
                           nv * d * 2 + (2 * d * f + 4 * d * d) * wb)]
        raise ValueError(self.kind)

    def flops(self, new_tokens, context, batch) -> float:
        return sum(k.flops for k in self.kernels(new_tokens, context, batch))
