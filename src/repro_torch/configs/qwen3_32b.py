"""qwen3-32b [dense] — 64L d_model=5120 64H (GQA kv=8) d_ff=25600
vocab=151936, qk_norm. [hf:Qwen/Qwen3-8B family]

Copy of repro/configs/qwen3_32b.py."""
from repro_torch.configs.base import AttentionConfig, ModelConfig

ARCH_ID = "qwen3-32b"


def make_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        arch_type="dense",
        source="hf:Qwen/Qwen3-8B",
        n_layers=64,
        d_model=5120,
        vocab_size=151_936,
        d_ff=25_600,
        attention=AttentionConfig(
            n_heads=64, n_kv_heads=8, head_dim=128, qk_norm=True,
            rope_theta=1e6,
        ),
        mixer="attention",
        mlp="dense",
    )


def make_smoke_config() -> ModelConfig:
    return make_config().replace(
        n_layers=2,
        d_model=128,
        vocab_size=512,
        d_ff=512,
        attention=AttentionConfig(n_heads=4, n_kv_heads=2, head_dim=32, qk_norm=True),
    )
