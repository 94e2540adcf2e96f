"""qwen2-0.5b [dense] — 24L d_model=896 14H (GQA kv=2) d_ff=4864 vocab=151936.
GQA with QKV bias. [arXiv:2407.10671]

Copy of repro/configs/qwen2_0_5b.py."""
from repro_torch.configs.base import AttentionConfig, ModelConfig

ARCH_ID = "qwen2-0.5b"


def make_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        arch_type="dense",
        source="arXiv:2407.10671",
        n_layers=24,
        d_model=896,
        vocab_size=151_936,
        d_ff=4864,
        attention=AttentionConfig(
            n_heads=14, n_kv_heads=2, head_dim=64, qkv_bias=True,
            rope_theta=1e6,
        ),
        mixer="attention",
        mlp="dense",
        tie_embeddings=True,
    )


def make_smoke_config() -> ModelConfig:
    return make_config().replace(
        n_layers=2,
        d_model=128,
        vocab_size=512,
        d_ff=256,
        attention=AttentionConfig(n_heads=4, n_kv_heads=2, head_dim=32, qkv_bias=True),
    )
