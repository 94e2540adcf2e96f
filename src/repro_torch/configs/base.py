"""Model configs (the LLM zoo), federated / wireless / compute configs
(the paper's system model) and the dry run's production meshes
(MeshConfig).

Copy of repro/configs/base.py's dataclasses, kept here so the port
imports nothing of the reference package. The model sub-configs the port
does not run yet (MoE, modality) are copied too, so a ModelConfig
compares field for field with the reference's."""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

# ---------------------------------------------------------------------------
# Model sub-configs
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class AttentionConfig:
    n_heads: int
    n_kv_heads: int
    head_dim: int
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    # None = full causal attention; int = sliding-window size.
    sliding_window: Optional[int] = None


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    # Optional always-on shared expert (Llama-4 style).
    shared_expert_d_ff: Optional[int] = None
    router_aux_weight: float = 0.01
    capacity_factor: float = 1.25
    # 'global': one capacity buffer over all tokens; 'batched': dispatch
    # per batch row.
    dispatch: str = "global"


@dataclass(frozen=True)
class SSMConfig:
    kind: str  # 'mamba1' | 'mamba2'
    d_state: int
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64  # mamba2 only
    n_groups: int = 1  # mamba2 only
    chunk: int = 128  # scan chunk length


@dataclass(frozen=True)
class ModalityConfig:
    """Stub frontend description for [vlm]/[audio] archs: precomputed
    patch/frame embeddings with ``embed_dim`` features and ``prefix_len``
    positions, consumed by the decoder through a linear projector."""

    kind: str  # 'vision' | 'audio'
    embed_dim: int
    prefix_len: int
    n_codebooks: int = 1  # audio: EnCodec codebooks (parallel heads)


# ---------------------------------------------------------------------------
# Model config
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str  # dense | moe | ssm | hybrid | vlm | audio
    source: str  # citation bracket from the assignment
    n_layers: int
    d_model: int
    vocab_size: int
    d_ff: int = 0  # dense-MLP hidden size (0 for attn-free / pure-MoE)
    attention: Optional[AttentionConfig] = None
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    modality: Optional[ModalityConfig] = None
    # 'attention' | 'mamba1' | 'mamba2' — the per-layer sequence mixer.
    mixer: str = "attention"
    # 'dense' | 'moe' | 'none' — the per-layer channel mixer.
    mlp: str = "dense"
    act: str = "silu"  # 'silu' (SwiGLU) | 'gelu' (GeGLU)
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    # Zamba2-style tied shared attention+MLP block applied every k backbone
    # layers (None = no shared block).
    shared_attn_every: Optional[int] = None
    shared_attn_heads: int = 32
    # Layers per scan group: parameters are stacked (n_layers // scan_group,
    # scan_group, ...).
    scan_group: int = 1
    # Rematerialize activations in training (the reference's lever; the
    # port's serving path does not read it).
    remat: bool = True
    dtype: str = "bfloat16"

    # -- derived -----------------------------------------------------------
    @property
    def attn_dim(self) -> int:
        a = self.attention
        return a.n_heads * a.head_dim if a else 0

    @property
    def n_scan_groups(self) -> int:
        if self.n_layers % self.scan_group:
            raise ValueError(f"{self.name}: n_layers={self.n_layers} % "
                             f"scan_group={self.scan_group} != 0")
        return self.n_layers // self.scan_group

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # -- analytic parameter counts ------------------------------------------
    def _attn_params(self, heads: int, kv: int, hd: int) -> int:
        d = self.d_model
        p = d * heads * hd + 2 * d * kv * hd + heads * hd * d
        if self.attention and self.attention.qkv_bias:
            p += (heads + 2 * kv) * hd
        if self.attention and self.attention.qk_norm:
            p += 2 * hd
        return p

    def _dense_mlp_params(self, d_ff: int) -> int:
        return 3 * self.d_model * d_ff  # gate, up, down

    def _moe_params(self) -> Tuple[int, int]:
        """(total, active) MoE params per layer."""
        m = self.moe
        e = 3 * self.d_model * m.d_ff_expert
        total = m.n_experts * e + self.d_model * m.n_experts
        active = m.top_k * e + self.d_model * m.n_experts
        if m.shared_expert_d_ff:
            s = self._dense_mlp_params(m.shared_expert_d_ff)
            total += s
            active += s
        return total, active

    def _ssm_params(self) -> int:
        s = self.ssm
        d = self.d_model
        d_in = s.expand * d
        if s.kind == "mamba1":
            dt_rank = max(d // 16, 1)
            p = d * 2 * d_in  # in_proj
            p += d_in * s.d_conv + d_in  # conv1d + bias
            p += d_in * (dt_rank + 2 * s.d_state)  # x_proj
            p += dt_rank * d_in + d_in  # dt_proj
            p += d_in * s.d_state + d_in  # A_log, D
            p += d_in * d  # out_proj
            return p
        # mamba2
        n_heads = d_in // s.head_dim
        conv_dim = d_in + 2 * s.n_groups * s.d_state
        p = d * (2 * d_in + 2 * s.n_groups * s.d_state + n_heads)  # in_proj
        p += conv_dim * s.d_conv + conv_dim  # conv1d
        p += 3 * n_heads  # A_log, D, dt_bias
        p += d_in  # gated rmsnorm
        p += d_in * d  # out_proj
        return p

    def param_count(self) -> Tuple[int, int]:
        """Analytic (total, active) parameter count. Approximate to ~1%."""
        d = self.d_model
        total = self.vocab_size * d  # embedding
        if self.modality and self.modality.kind == "audio":
            total += (self.modality.n_codebooks - 1) * self.vocab_size * d
        if self.modality:
            total += self.modality.embed_dim * d + d  # projector
        per_layer = 2 * d  # 2 rmsnorm scales
        if self.mixer == "attention":
            a = self.attention
            per_layer += self._attn_params(a.n_heads, a.n_kv_heads, a.head_dim)
        else:
            per_layer += self._ssm_params()
        active_per_layer = per_layer
        if self.mlp == "dense":
            per_layer += self._dense_mlp_params(self.d_ff)
            active_per_layer += self._dense_mlp_params(self.d_ff)
        elif self.mlp == "moe":
            t, a_ = self._moe_params()
            per_layer += t
            active_per_layer += a_
        total_layers = total + self.n_layers * per_layer
        active = total + self.n_layers * active_per_layer
        if self.shared_attn_every:
            hd = d // self.shared_attn_heads
            shared = self._attn_params(self.shared_attn_heads,
                                       self.shared_attn_heads, hd)
            shared += self._dense_mlp_params(4 * d) + 2 * d
            total_layers += shared
            active += shared
        total_layers += d  # final norm
        active += d
        if not self.tie_embeddings:
            n_heads_out = self.modality.n_codebooks if self.modality else 1
            total_layers += n_heads_out * d * self.vocab_size
            active += n_heads_out * d * self.vocab_size
        return int(total_layers), int(active)


# ---------------------------------------------------------------------------
# Input shapes (assigned)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # 'train' | 'prefill' | 'decode'


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}


# ---------------------------------------------------------------------------
# Federated / wireless / compute configs (the paper's system model)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class WirelessConfig:
    """Paper §II-C communication model parameters (Eq. 6)."""

    bandwidth_hz: float = 20e6  # B = 20 MHz
    noise_dbm_per_hz: float = -174.0  # N_o
    tx_power_w: float = 0.5  # p_m
    # Channel gains h_m are drawn per device by the simulator; this is the
    # mean pathloss used when a deterministic value is needed.
    mean_channel_gain: float = 1e-8


@dataclass(frozen=True)
class ComputeConfig:
    """Paper §II-B computation model parameters (Eqs. 3-4)."""

    # GPU frequency model constants (Eq. 3), from Abe et al. [12].
    a_s: float = 1e-10
    a_c: float = 0.7
    a_m: float = 0.3
    core_freq_hz: float = 2.0e9  # f_c (paper: 2 GHz cap)
    mem_freq_hz: float = 7.0e9  # f_M
    cycles_per_bit: float = 30.0  # G_m base (paper: 30 cycles/bit)
    # Per-sample bits processed per iteration (dataset dependent).
    bits_per_sample: float = 28 * 28 * 8.0


@dataclass(frozen=True)
class FedConfig:
    """DEFL algorithm configuration (Alg. 1)."""

    n_devices: int = 10  # M
    epsilon: float = 0.01  # preset global convergence error
    theta: float = 0.15  # relative local error (theta* from Eq. 29)
    batch_size: int = 32  # b (b* from Eq. 29)
    nu: float = 2.0  # ν: step-size/gradient-noise constant (Remark 3)
    c: float = 1.0  # big-O constant of Eq. 12
    lr: float = 0.01
    update_bytes: Optional[int] = None  # s; None -> actual param bytes
    # Beyond-paper: int8 update compression on the uplink.
    compress_updates: bool = False
    seed: int = 0

    @property
    def local_rounds(self) -> int:
        """V = ν·log(1/θ) (Remark 3), at least 1."""
        return max(int(round(self.nu * np.log(1.0 / max(self.theta, 1e-9)))), 1)


@dataclass(frozen=True)
class MeshConfig:
    multi_pod: bool = False

    @property
    def shape(self):
        return (2, 16, 16) if self.multi_pod else (16, 16)

    @property
    def axes(self):
        return ("pod", "data", "model") if self.multi_pod else ("data", "model")

    @property
    def n_devices(self) -> int:
        return int(np.prod(self.shape))

    @property
    def client_axes(self):
        return ("pod", "data") if self.multi_pod else ("data",)

    @property
    def n_clients(self) -> int:
        return 32 if self.multi_pod else 16
