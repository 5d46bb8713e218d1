"""The analytic operations of serving a Nemotron-H decoder, frozen.

Per layer kind, as the layer needs it (not as a kernel computes it):

- Mamba-2, per token: two operations per weight of the in- and
  out-projections; the depthwise conv's multiply-add per tap and
  channel; the gated norm's five per inner channel (the gate's product,
  the square, the sum, the scaling and the scale). The scan, per decoded
  token, is one recurrence step: per state element the decay, the input's
  outer product and their sum, and two for the readout ``C h``; per inner
  channel two for the D skip. Per prompt it is the chunked form at the
  published ``chunk_size`` Q: in each chunk of q tokens the causal pairs'
  C B products per group (2 N each) and their weighted sums of x per head
  (2 P each), the chunk's state (2 P N per token and head) and the
  read-out of the carried state (2 P N per token and head), the carry
  into the next chunk (2 per state element) and the D skip;
- MLP: two operations per weight of its two products;
- attention: two per weight of its projections and the two products
  over the visible positions (2 hd per visible key per head, twice).

Each logits row costs 2 d V. The pre-norms, the activations, the softmax
and the conv's SiLU are not counted, as ``work.py`` counts none of them.
"""
from __future__ import annotations


def mamba_proj(s) -> int:
    return 2 * s.d * (s.d_inner + s.conv_channels + s.m_heads) \
        + 2 * s.d_inner * s.d


def mamba_conv(s) -> int:
    return 2 * s.conv * s.conv_channels


def mamba_norm(s) -> int:
    return 5 * s.d_inner


def state_elements(s) -> int:
    return s.m_heads * s.m_head_dim * s.state


def ssd_step(s) -> int:
    """One decoded token's recurrence step: 3 per state element, 2 per
    state element for the readout, 2 per inner channel for D."""
    return 5 * state_elements(s) + 2 * s.d_inner


def ssd_readout(s) -> int:
    """The product ``C h`` of one step, a part of ``ssd_step``."""
    return 2 * state_elements(s)


def ssd_chunked(s, T: int) -> int:
    """A prompt of T tokens through the chunked scan at ``s.chunk``."""
    ops = 0
    for a in range(0, T, s.chunk):
        q = min(s.chunk, T - a)
        pairs = q * (q + 1) // 2
        ops += 2 * pairs * (s.groups * s.state
                            + s.m_heads * s.m_head_dim)
        ops += 4 * q * state_elements(s) + 2 * state_elements(s)
        ops += 2 * q * s.d_inner
    return ops


def mlp(s) -> int:
    return 2 * 2 * s.d * s.d_ff


def attn_proj(s) -> int:
    hd = s.head_dim
    return 2 * (s.d * (s.n_heads + 2 * s.n_kv) * hd + s.n_heads * hd * s.d)


def attn_scores(s, visible: int) -> int:
    """The two products of one query over ``visible`` positions."""
    return 4 * s.n_heads * s.head_dim * visible


def head_flops(s) -> int:
    return 2 * s.d * s.vocab


def token_flops(s, visible: int) -> int:
    """One decoded token through every layer, attending to ``visible``
    positions (itself included); no logits."""
    per = {"M": mamba_proj(s) + mamba_conv(s) + mamba_norm(s) + ssd_step(s),
           "-": mlp(s), "*": attn_proj(s) + attn_scores(s, visible)}
    return sum(per[k] for k in s.pattern)


def prompt_flops(s, T: int) -> int:
    """A prompt of T tokens, causal, and its one logits row."""
    per = {"M": T * (mamba_proj(s) + mamba_conv(s) + mamba_norm(s))
           + ssd_chunked(s, T),
           "-": T * mlp(s),
           "*": T * attn_proj(s) + attn_scores(s, T * (T + 1) // 2)}
    return sum(per[k] for k in s.pattern) + head_flops(s)
