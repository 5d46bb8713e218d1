"""qwen3-14b — dense GQA with qk_norm [hf:Qwen/Qwen3-8B; hf]."""
from repro_torch.config import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="qwen3-14b", family="dense",
        n_layers=40, d_model=5120, n_heads=40, n_kv_heads=8,
        d_ff=17408, vocab=151936, head_dim=128,
        qk_norm=True, mlp="swiglu", pos="rope", rope_theta=1_000_000.0,
        source="hf:Qwen/Qwen3-8B; hf",
    )


def smoke() -> ModelConfig:
    return full().replace(
        name="qwen3-14b-smoke", n_layers=2, d_model=80, n_heads=5, n_kv_heads=1,
        head_dim=16, d_ff=160, vocab=256,
    )
