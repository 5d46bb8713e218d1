"""musicgen-medium — decoder-only over EnCodec tokens [arXiv:2306.05284; hf].

4 codebooks, vocab 2048 each; the EnCodec frontend is a STUB (token ids in,
summed codebook embeddings). MHA (kv == heads). Sinusoidal positions per
AudioCraft; GELU FFN.
"""
from repro_torch.config import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="musicgen-medium", family="audio",
        n_layers=48, d_model=1536, n_heads=24, n_kv_heads=24,
        d_ff=6144, vocab=2048, head_dim=64,
        mlp="gelu", pos="sin", n_codebooks=4,
        norm_eps=1e-5,
        source="arXiv:2306.05284; hf",
    )


def smoke() -> ModelConfig:
    return full().replace(
        name="musicgen-medium-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=4, head_dim=16, d_ff=256, vocab=64, n_codebooks=4,
    )
