"""qwen2-0.5b — dense GQA with QKV bias [arXiv:2407.10671; hf]."""
from repro_torch.config import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="qwen2-0.5b", family="dense",
        n_layers=24, d_model=896, n_heads=14, n_kv_heads=2,
        d_ff=4864, vocab=151936, head_dim=64,
        qkv_bias=True, mlp="swiglu", pos="rope", rope_theta=1_000_000.0,
        tie_embeddings=True,
        source="arXiv:2407.10671; hf",
    )


def smoke() -> ModelConfig:
    return full().replace(
        name="qwen2-0.5b-smoke", n_layers=2, d_model=56, n_heads=7, n_kv_heads=1,
        head_dim=8, d_ff=112, vocab=256,
    )
