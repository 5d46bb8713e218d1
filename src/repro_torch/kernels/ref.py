"""Plain PyTorch versions of the port's hand-written kernels.

Each function computes exactly what its kernel computes, in the most
direct way. The wrappers in this package call them for tensors that lie on
the CPU (the tests), and ``chip_smoke.py`` holds each kernel against them
on the card.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def streamed_matmul_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """K1: ``(M, K) @ (K, N)`` with both operands upcast to f32, an f32
    sum over K, and the result cast back to ``x.dtype``."""
    return (x.to(torch.float32) @ w.to(torch.float32)).to(x.dtype)


def streamed_matmul_int8_ref(x: torch.Tensor, w_q: torch.Tensor,
                             scales: torch.Tensor) -> torch.Tensor:
    """K2: ``x.f32 @ dequant_int8(w_q, scales)`` cast to ``x.dtype``; the
    group size comes from the shapes (``g = ceil(K / G)``)."""
    from repro_torch.kernels.streamed_matmul import dequant_int8
    return (x.to(torch.float32) @ dequant_int8(w_q, scales)).to(x.dtype)


def streamed_matmul_int4_ref(x: torch.Tensor, w_packed: torch.Tensor,
                             scales: torch.Tensor,
                             zeros: torch.Tensor) -> torch.Tensor:
    """K3: ``x.f32 @ dequant_int4(w_packed, scales, zeros)`` cast to
    ``x.dtype``."""
    from repro_torch.kernels.streamed_matmul import dequant_int4
    w = dequant_int4(w_packed, scales, zeros)
    return (x.to(torch.float32) @ w).to(x.dtype)


def _scores(q, k, causal):
    """(B, KV, G, Tq, Tk) f32 scores of q (B, H, Tq, hd) against k
    (B, KV, Tk, hd), times ``hd ** -0.5``, masked at ``NEG_INF`` (causal),
    and q as (B, KV, G, Tq, hd) f32."""
    B, H, Tq, hd = q.shape
    KV, Tk = k.shape[1], k.shape[2]
    qg = q.reshape(B, KV, H // KV, Tq, hd).to(torch.float32)
    s = torch.einsum("bkgtd,bksd->bkgts", qg, k.to(torch.float32)) \
        * hd ** -0.5
    if causal:
        mask = torch.arange(Tk, device=q.device)[None, :] \
            <= torch.arange(Tq, device=q.device)[:, None]
        s = torch.where(mask, s, NEG_INF)
    return s, qg


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool, return_lse: bool = False):
    """K4: q (B, H, Tq, hd), k and v (B, KV, Tk, hd) with H % KV == 0,
    upcast to f32 and fully materialised: GQA through a reshape to
    (B, KV, G, Tq, hd), f32 scores times ``hd ** -0.5``, the causal mask
    ``kpos <= qpos`` (both from 0) at ``NEG_INF``, softmax, ``p @ v`` in
    f32, the result in ``q.dtype``. With ``return_lse`` also the f32 row
    logsumexp of the scores, (B, H, Tq), which K4 writes for its
    backward."""
    B, H, Tq, hd = q.shape
    s, _ = _scores(q, k, causal)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgts,bksd->bkgtd", p, v.to(torch.float32))
    o = o.reshape(B, H, Tq, hd).to(q.dtype)
    if return_lse:
        return o, torch.logsumexp(s, dim=-1).reshape(B, H, Tq)
    return o


def flash_attention_bwd_ref(q, k, v, dout, lse, *, causal: bool):
    """K4's backward: the gradients (dq, dk, dv) of
    ``flash_attention_ref(q, k, v)`` for the output gradient ``dout``,
    given the forward's row logsumexp ``lse`` (B, H, Tq), in f32 and fully
    materialised: p = exp(s - lse) (0 where masked), dp = dout v^T,
    D = rowsum(p dp), dv = p^T dout, ds = p (dp - D), dq = ds k / sqrt(hd),
    dk = ds^T q / sqrt(hd), each kv head's dk and dv summed over its query
    heads; the results in the inputs' dtypes."""
    B, H, Tq, hd = q.shape
    KV, Tk = k.shape[1], k.shape[2]
    G = H // KV
    f32 = torch.float32
    s, qg = _scores(q, k, causal)
    p = torch.exp(s - lse.reshape(B, KV, G, Tq, 1).to(f32))
    if causal:
        p = torch.where(s > NEG_INF / 2, p, 0.0)
    del s
    dog = dout.reshape(B, KV, G, Tq, hd).to(f32)
    kf, vf = k.to(f32), v.to(f32)
    dv = torch.einsum("bkgts,bkgtd->bksd", p, dog)
    dp = torch.einsum("bkgtd,bksd->bkgts", dog, vf)
    ds = p * (dp - (p * dp).sum(-1, keepdim=True))
    del p, dp
    dq = torch.einsum("bkgts,bksd->bkgtd", ds, kf) * hd ** -0.5
    dk = torch.einsum("bkgts,bkgtd->bksd", ds, qg) * hd ** -0.5
    return (dq.reshape(B, H, Tq, hd).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))
