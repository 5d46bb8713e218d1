"""Operations and bytes, frozen.

``k1_work`` is the hand count of one K1 call, as ``launch/counting.py``
counts it: an (M, K) @ (K, N) product takes 2MKN operations and reads x
and the weight once and writes y once. ``k1_bound_s`` is the least time
the card could take for it: bytes over the HBM rate or operations over
the dtype's peak, the larger.

``token_flops`` and ``head_flops`` are the analytic operations of
serving: each token processed through a layer costs two operations per
weight its products use (attention projections, the dense FFN, or the
router and the top-k experts) plus the attention's two products over the
positions it sees (2 hd operations per visible key per head, twice);
each logits row costs 2 d V. They count what the model needs, not what a
kernel computes: an expert's padded capacity rows and masked cache
positions are not counted.
"""
from __future__ import annotations

from . import peaks


def k1_work(M, K, N, dtype_bytes):
    return 2 * M * K * N, (M * K + M * N + K * N) * dtype_bytes


def k1_bound_s(M, K, N, dtype):
    ops, byts = k1_work(M, K, N, 4 if dtype == "float32" else 2)
    return max(byts / peaks.HBM_BYTES_S, ops / peaks.FLOPS_OF[dtype])


def layer_matmul_params(s) -> int:
    """Weights one token's products use in one layer."""
    hd = s.head_dim
    attn = s.d * (s.n_heads + 2 * s.n_kv) * hd + s.n_heads * hd * s.d
    if s.moe:
        return attn + s.d * s.n_experts + s.top_k * 3 * s.d * s.d_ff
    return attn + 3 * s.d * s.d_ff


def token_flops(s, visible: int) -> int:
    """One token through every layer, attending to ``visible``
    positions (itself included); no logits."""
    attn = 4 * s.n_heads * s.head_dim * visible
    return s.n_layers * (2 * layer_matmul_params(s) + attn)


def prompt_flops(s, T: int) -> int:
    """A prompt of T tokens, causal, and its one logits row."""
    per = 2 * layer_matmul_params(s) * T + \
        4 * s.n_heads * s.head_dim * T * (T + 1) // 2
    return s.n_layers * per + head_flops(s)


def head_flops(s) -> int:
    return 2 * s.d * s.vocab
