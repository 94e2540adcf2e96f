"""qwen3-moe-30b-a3b [moe] — 48L d_model=2048 32H (GQA kv=4) d_ff(expert)=768
vocab=151936, MoE 128 experts top-8. [hf:Qwen/Qwen3-30B-A3B]

Copy of repro/configs/qwen3_moe_30b_a3b.py."""
from repro_torch.configs.base import AttentionConfig, ModelConfig, MoEConfig

ARCH_ID = "qwen3-moe-30b-a3b"


def make_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        arch_type="moe",
        source="hf:Qwen/Qwen3-30B-A3B",
        n_layers=48,
        d_model=2048,
        vocab_size=151_936,
        attention=AttentionConfig(
            n_heads=32, n_kv_heads=4, head_dim=128, qk_norm=True,
            rope_theta=1e6,
        ),
        moe=MoEConfig(n_experts=128, top_k=8, d_ff_expert=768),
        mixer="attention",
        mlp="moe",
    )


def make_smoke_config() -> ModelConfig:
    return make_config().replace(
        n_layers=2,
        d_model=128,
        vocab_size=512,
        attention=AttentionConfig(n_heads=4, n_kv_heads=2, head_dim=32, qk_norm=True),
        moe=MoEConfig(n_experts=4, top_k=2, d_ff_expert=64),
    )
