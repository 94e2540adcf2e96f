"""moonshot-v1-16b-a3b — 48L d_model=2048 16H (GQA kv=16) d_ff(expert)=1408
vocab=163840, MoE 64 experts top-6. [hf:moonshotai/Moonlight-16B-A3B]

An MoE model (64 experts, top 6, and a shared expert), as in the
reference.

Copy of repro/configs/moonshot_v1_16b_a3b.py."""
from repro_torch.configs.base import AttentionConfig, ModelConfig, MoEConfig

ARCH_ID = "moonshot-v1-16b-a3b"


def make_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        arch_type="moe",
        source="hf:moonshotai/Moonlight-16B-A3B",
        n_layers=48,
        d_model=2048,
        vocab_size=163_840,
        attention=AttentionConfig(n_heads=16, n_kv_heads=16, head_dim=128),
        moe=MoEConfig(n_experts=64, top_k=6, d_ff_expert=1408,
                      shared_expert_d_ff=2816),
        mixer="attention",
        mlp="moe",
    )


def make_smoke_config() -> ModelConfig:
    return make_config().replace(
        n_layers=2,
        d_model=128,
        vocab_size=512,
        attention=AttentionConfig(n_heads=4, n_kv_heads=4, head_dim=32),
        moe=MoEConfig(n_experts=4, top_k=2, d_ff_expert=64, shared_expert_d_ff=64),
    )
