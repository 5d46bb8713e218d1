"""Where the port runs: the CUDA card unless the caller asks for the CPU."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the CUDA card. A CUDA device without CUDA raises; the
    port never carries on on the CPU unless ``device="cpu"`` was passed.

    On CUDA this also turns off the reduced-precision matmul modes, so the
    plain ``torch.matmul`` calls (qkv, wo, the head, attention) sum in full
    f32 without TF32 and without bf16 partial reductions:
    ``torch.backends.cuda.matmul.allow_tf32 = False`` and
    ``allow_bf16_reduced_precision_reduction = False``."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass "
                               "device='cpu' to run on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
            False
    elif device.type != "cpu":
        raise ValueError(f"unsupported device {device}")
    return device
