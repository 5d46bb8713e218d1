"""nemo8b — mistral-nemo-minitron-8b, one of the paper's IGI SDK models.

Approximate public config [hf:nvidia/Mistral-NeMo-Minitron-8B-Instruct]:
32L, d=4096, 32H GQA kv=8, d_ff=11520, vocab=131072. Used by the paper-table
benchmarks (Table 4 / Figures 2-5), not part of the 10 assigned archs.
"""
from repro_torch.config import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="nemo8b", family="dense",
        n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
        d_ff=11520, vocab=131072, head_dim=128,
        mlp="swiglu", pos="rope", rope_theta=1_000_000.0,
        source="hf:nvidia/Mistral-NeMo-Minitron-8B-Instruct; approx",
    )


def smoke() -> ModelConfig:
    return full().replace(
        name="nemo8b-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        head_dim=16, d_ff=128, vocab=256,
    )
