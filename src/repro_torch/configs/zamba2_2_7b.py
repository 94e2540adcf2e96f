"""zamba2-2.7b [hybrid] — 54L d_model=2560, Mamba2 backbone (ssm_state=64)
with a tied shared attention block (32H) every 6 layers. [arXiv:2411.15242]

Copy of repro/configs/zamba2_2_7b.py."""
from repro_torch.configs.base import ModelConfig, SSMConfig

ARCH_ID = "zamba2-2.7b"


def make_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        arch_type="hybrid",
        source="arXiv:2411.15242",
        n_layers=54,
        d_model=2560,
        vocab_size=32_000,
        ssm=SSMConfig(kind="mamba2", d_state=64, d_conv=4, expand=2, head_dim=64),
        mixer="mamba2",
        mlp="none",
        shared_attn_every=6,
        shared_attn_heads=32,
        scan_group=6,
        tie_embeddings=True,
    )


def make_smoke_config() -> ModelConfig:
    return make_config().replace(
        n_layers=2,
        d_model=128,
        vocab_size=512,
        ssm=SSMConfig(kind="mamba2", d_state=16, d_conv=4, expand=2, head_dim=32, chunk=32),
        shared_attn_every=2,
        shared_attn_heads=4,
        scan_group=2,
    )
