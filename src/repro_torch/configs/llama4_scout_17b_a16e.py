"""llama4-scout-17b-a16e [moe] — 48L d_model=5120 40H (GQA kv=8)
d_ff(expert)=8192 vocab=202048, MoE 16 experts top-1 + shared expert.
[hf:meta-llama/Llama-4-Scout-17B-16E]

Copy of repro/configs/llama4_scout_17b_a16e.py."""
from repro_torch.configs.base import AttentionConfig, ModelConfig, MoEConfig

ARCH_ID = "llama4-scout-17b-a16e"


def make_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        arch_type="moe",
        source="hf:meta-llama/Llama-4-Scout-17B-16E",
        n_layers=48,
        d_model=5120,
        vocab_size=202_048,
        attention=AttentionConfig(
            n_heads=40, n_kv_heads=8, head_dim=128, rope_theta=5e5,
        ),
        moe=MoEConfig(
            n_experts=16, top_k=1, d_ff_expert=8192, shared_expert_d_ff=8192,
        ),
        mixer="attention",
        mlp="moe",
    )


def make_smoke_config() -> ModelConfig:
    return make_config().replace(
        n_layers=2,
        d_model=128,
        vocab_size=512,
        attention=AttentionConfig(n_heads=4, n_kv_heads=2, head_dim=32),
        moe=MoEConfig(n_experts=4, top_k=1, d_ff_expert=64, shared_expert_d_ff=64),
    )
