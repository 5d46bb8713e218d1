"""Model-facing wrapper around K4 in the model layout.

``flash_attention_bthd`` takes q (B, T, H, hd) and k, v (B, T, KV, hd), as
the attention layer holds them, to K4's (B, heads, T, hd) as strided views
(no copy) and writes K4's output straight into a (B, T, H, hd) tensor. The
reference's ``force`` / ``interpret`` switch has no counterpart: the
tensors' device decides, CPU tensors taking the plain version and CUDA
tensors the kernel.
"""
from __future__ import annotations

import torch

from repro_torch.device import on_cpu
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels.ref import flash_attention_ref


def flash_attention_bthd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, block_q: int = 128,
                         block_k: int = 128) -> torch.Tensor:
    """q: (B, T, H, hd); k, v: (B, S, KV, hd) -> (B, T, H, hd)."""
    qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
    cpu = on_cpu("flash_attention_bthd", q, k, v)
    fa.check_inputs(qh, kh, vh, block_q, block_k)
    if cpu:
        return flash_attention_ref(qh, kh, vh, causal=causal).transpose(1, 2)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    fa.launch(qh, kh, vh, out.transpose(1, 2), causal=causal,
              block_q=block_q, block_k=block_k)
    return out
