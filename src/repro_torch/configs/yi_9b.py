"""yi-9b — llama-arch dense GQA LM [arXiv:2403.04652; hf]."""
from repro_torch.config import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="yi-9b", family="dense",
        n_layers=48, d_model=4096, n_heads=32, n_kv_heads=4,
        d_ff=11008, vocab=64000, head_dim=128,
        mlp="swiglu", pos="rope", rope_theta=10_000.0,
        source="arXiv:2403.04652; hf",
    )


def smoke() -> ModelConfig:
    return full().replace(
        name="yi-9b-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        head_dim=16, d_ff=128, vocab=256,
    )
