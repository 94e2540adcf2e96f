"""gemma-7b [dense] — 28L d_model=3072 16H (kv=16) d_ff=24576 vocab=256000.
GeGLU MLP, head_dim=256. [arXiv:2403.08295]

Copy of repro/configs/gemma_7b.py."""
from repro_torch.configs.base import AttentionConfig, ModelConfig

ARCH_ID = "gemma-7b"


def make_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        arch_type="dense",
        source="arXiv:2403.08295",
        n_layers=28,
        d_model=3072,
        vocab_size=256_000,
        d_ff=24_576,
        attention=AttentionConfig(n_heads=16, n_kv_heads=16, head_dim=256),
        mixer="attention",
        mlp="dense",
        act="gelu",
        tie_embeddings=True,
    )


def make_smoke_config() -> ModelConfig:
    return make_config().replace(
        n_layers=2,
        d_model=128,
        vocab_size=512,
        d_ff=512,
        attention=AttentionConfig(n_heads=4, n_kv_heads=4, head_dim=32),
    )
