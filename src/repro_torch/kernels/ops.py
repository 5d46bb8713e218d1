"""Model-facing wrapper around K4 in the model layout.

``flash_attention_bthd`` takes q (B, T, H, hd) and k, v (B, T, KV, hd), as
the attention layer holds them, to K4's (B, heads, T, hd) as strided views
(no copy) and writes K4's output straight into a (B, T, H, hd) tensor. The
reference's ``force`` / ``interpret`` switch has no counterpart: the
tensors' device decides, CPU tensors taking the plain version and CUDA
tensors the kernel. When autograd needs a gradient the call runs through
``flash_attention.FlashAttention`` in this layout, whose backward writes
dq, dk and dv straight into (B, T, heads, hd) tensors. Inside a count
(``launch/counting.py``) a call is one K4 unit, as ``flash_attention``'s.
"""
from __future__ import annotations

import torch

from repro_torch.device import needs_grad, on_cpu
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels.ref import flash_attention_ref
from repro_torch.launch import counting


def flash_attention_bthd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, block_q: int = 128,
                         block_k: int = 128) -> torch.Tensor:
    """q: (B, T, H, hd); k, v: (B, S, KV, hd) -> (B, T, H, hd)."""
    if needs_grad(q, k, v):
        return fa.FlashAttention.apply(q, k, v, causal, block_q, block_k,
                                       True)
    qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
    if counting.active() is not None:
        shape = fa.check_inputs(qh, kh, vh, block_q, block_k)
        return fa.count_unit(
            "K4", counting.flash_work(shape, causal, q.element_size()), q,
            ((q.shape, q.dtype),),
            lambda: (_bthd(q, k, v, causal, block_q, block_k),))
    return _bthd(q, k, v, causal, block_q, block_k)


def _bthd(q, k, v, causal, block_q, block_k):
    qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
    cpu = on_cpu("flash_attention_bthd", q, k, v)
    fa.check_inputs(qh, kh, vh, block_q, block_k)
    if cpu:
        return flash_attention_ref(qh, kh, vh, causal=causal).transpose(1, 2)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    fa.launch(qh, kh, vh, out.transpose(1, 2), causal=causal,
              block_q=block_q, block_k=block_k)
    return out
