"""Plain PyTorch versions of the port's hand-written kernels.

Each function computes exactly what its kernel computes, in the most
direct way. The wrappers in this package call them for tensors that lie on
the CPU (the tests), and ``chip_smoke.py`` holds each kernel against them
on the card.
"""
from __future__ import annotations

import torch


def streamed_matmul_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """K1: ``(M, K) @ (K, N)`` with both operands upcast to f32, an f32
    sum over K, and the result cast back to ``x.dtype``."""
    return (x.to(torch.float32) @ w.to(torch.float32)).to(x.dtype)
