"""PyTorch/CUDA port of the VRAM-constrained pipelined-sharding runtime.

The JAX package ``repro`` is the reference; this package mirrors its module
layout and never imports it."""
from repro_torch.session import Session  # noqa: F401
