"""Where the port runs: the CUDA card unless the caller asks for the CPU.

``resolve_device`` is the rule for entry points; ``on_cpu`` is the one
every kernel wrapper follows: tensors on the CPU take the plain version,
tensors on one CUDA device take the kernel, and anything else raises.
``needs_grad`` says whether autograd records a call (the wrappers then
take their gradient's path, the SSD its out-of-place forms). ``is_fake``
says whether a tensor is a fake tensor (shape, dtype and device, no
storage), which only a count (``launch/counting.py``) takes."""
from __future__ import annotations

import torch
from torch._guards import detect_fake_mode
from torch._subclasses.fake_tensor import FakeTensor


def resolve_device(device=None) -> torch.device:
    """``None`` means the CUDA card. A CUDA device without CUDA raises; the
    port never carries on on the CPU unless ``device="cpu"`` was passed.

    On CUDA this also turns off the reduced-precision matmul modes, so the
    plain ``torch.matmul`` calls (qkv, wo, the head, attention) sum in full
    f32 without TF32 and without bf16 partial reductions:
    ``torch.backends.cuda.matmul.allow_tf32 = False`` and
    ``allow_bf16_reduced_precision_reduction = False``.

    Under a fake tensor mode (the specs a count runs on) the device is
    taken as it is: fake tensors claim a device and allocate nothing."""
    device = torch.device("cuda" if device is None else device)
    if detect_fake_mode() is not None and device.type in ("cpu", "cuda"):
        return device
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


def is_fake(t) -> bool:
    return isinstance(t, FakeTensor)


def on_cpu(name, x, *ws) -> bool:
    """True when every tensor lies on the CPU (the plain version runs);
    False when all lie on one CUDA device with CUDA available (the kernel
    runs). Anything else raises: there is no fallback. A fake tensor
    raises too: only a count takes one, and inside a count the wrappers
    take their counting path before they get here."""
    if is_fake(x) or any(is_fake(t) for t in ws):
        raise ValueError(f"{name}: a fake tensor outside a count "
                         "(launch/counting.py::count_step)")
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


def needs_grad(*ts) -> bool:
    """True when autograd records ops on ``ts``: grad mode on and one of
    them requiring grad."""
    return torch.is_grad_enabled() and any(
        getattr(t, "requires_grad", False) for t in ts)
