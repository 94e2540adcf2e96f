"""llava-next-34b [vlm] — 60L d_model=7168 56H (GQA kv=8) d_ff=20480
vocab=64000, anyres tiling. [hf:llava-hf/llava-v1.6-mistral-7b-hf]

The ViT/SigLIP vision tower and the anyres tiling are a stub, as in the
reference: the caller supplies precomputed patch embeddings (prefix_len x
embed_dim), which the decoder takes through its linear projector.

Copy of repro/configs/llava_next_34b.py."""
from repro_torch.configs.base import AttentionConfig, ModalityConfig, ModelConfig

ARCH_ID = "llava-next-34b"


def make_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        arch_type="vlm",
        source="hf:llava-hf/llava-v1.6-mistral-7b-hf",
        n_layers=60,
        d_model=7168,
        vocab_size=64_000,
        d_ff=20_480,
        attention=AttentionConfig(
            n_heads=56, n_kv_heads=8, head_dim=128, rope_theta=5e6,
        ),
        modality=ModalityConfig(kind="vision", embed_dim=1024, prefix_len=1152),
        mixer="attention",
        mlp="dense",
    )


def make_smoke_config() -> ModelConfig:
    return make_config().replace(
        n_layers=2,
        d_model=128,
        vocab_size=512,
        d_ff=512,
        attention=AttentionConfig(n_heads=4, n_kv_heads=2, head_dim=32),
        modality=ModalityConfig(kind="vision", embed_dim=64, prefix_len=16),
    )
