"""musicgen-large [audio] — 48L d_model=2048 32H (kv=32) d_ff=8192
vocab=2048, decoder-only over EnCodec tokens (4 codebooks, delay pattern).
[arXiv:2306.05284]

The mel-spectrogram/EnCodec frontend is a stub, as in the reference: the
caller supplies the 4-codebook token grid and, optionally, precomputed
text-conditioning embeddings; the decoder sums the codebook embeddings
and has K parallel LM heads.

Copy of repro/configs/musicgen_large.py."""
from repro_torch.configs.base import (AttentionConfig, ModalityConfig,
                                      ModelConfig)

ARCH_ID = "musicgen-large"


def make_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        arch_type="audio",
        source="arXiv:2306.05284",
        n_layers=48,
        d_model=2048,
        vocab_size=2048,
        d_ff=8192,
        attention=AttentionConfig(n_heads=32, n_kv_heads=32, head_dim=64),
        modality=ModalityConfig(
            kind="audio", embed_dim=1536, prefix_len=128, n_codebooks=4,
        ),
        mixer="attention",
        mlp="dense",
        act="gelu",
    )


def make_smoke_config() -> ModelConfig:
    return make_config().replace(
        n_layers=2,
        d_model=128,
        vocab_size=256,
        d_ff=256,
        attention=AttentionConfig(n_heads=4, n_kv_heads=4, head_dim=32),
        modality=ModalityConfig(kind="audio", embed_dim=64, prefix_len=8,
                                n_codebooks=4),
    )
