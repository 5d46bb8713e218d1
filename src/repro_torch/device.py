"""Where the port runs: the CUDA card unless the caller asks for the CPU.

``resolve_device`` is the rule for entry points; ``on_cpu`` is the one
every kernel wrapper follows: tensors on the CPU take the plain version,
tensors on one CUDA device take the kernel, and anything else raises."""
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


def on_cpu(name, x, *ws) -> bool:
    """True when every tensor lies on the CPU (the plain version runs);
    False when all lie on one CUDA device with CUDA available (the kernel
    runs). Anything else raises: there is no fallback."""
    dev = x.device
    if dev.type not in ("cpu", "cuda") or any(t.device != dev for t in ws):
        ts = (x,) + ws
        raise ValueError(f"{name}: tensors on "
                         f"{sorted({str(t.device) for t in ts})}; "
                         f"{'both' if len(ts) == 2 else 'all'} must be on "
                         "the CPU or on one CUDA device")
    if dev.type == "cpu":
        return True
    if not torch.cuda.is_available():
        raise RuntimeError(f"{name}: CUDA tensor given but CUDA is not "
                           "available")
    return False
