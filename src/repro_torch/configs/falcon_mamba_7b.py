"""falcon-mamba-7b [ssm] — 64L d_model=4096, attention-free Mamba-1 blocks,
ssm_state=16, vocab=65024. [arXiv:2410.05355]

Copy of repro/configs/falcon_mamba_7b.py."""
from repro_torch.configs.base import ModelConfig, SSMConfig

ARCH_ID = "falcon-mamba-7b"


def make_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        arch_type="ssm",
        source="arXiv:2410.05355",
        n_layers=64,
        d_model=4096,
        vocab_size=65_024,
        ssm=SSMConfig(kind="mamba1", d_state=16, d_conv=4, expand=2),
        mixer="mamba1",
        mlp="none",
        tie_embeddings=True,
    )


def make_smoke_config() -> ModelConfig:
    return make_config().replace(
        n_layers=2,
        d_model=128,
        vocab_size=512,
        ssm=SSMConfig(kind="mamba1", d_state=8, d_conv=4, expand=2, chunk=32),
    )
