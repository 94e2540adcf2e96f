"""Analytic roofline cost model: a copy of repro/utils/analytic.py, whose
arithmetic (the model-axis size 16, 4-byte parameters, the remat factor)
gives dicts equal to the reference's.

The reference needs it because XLA's cost analysis visits a scanned
layer stack's loop body once. The port's dry run counts every op of one
eager step (launch/dryrun.py) and records its FLOPs over both
`analytic_costs` and `analytic_flops_as_run`, the same model of the step
the port runs (four departures, listed in its docstring). The model is
exact in the matmul terms ("as-written": dense full-S attention scores,
all-E expert capacity GEMMs), approximate in the elementwise terms (the
scan's, which the FLOP counter does not count), and the source of the
per-device HBM bytes and in-loop tensor-parallel collective bytes that
launch/postprocess.py adds.
"""
from __future__ import annotations

from typing import Dict


from repro_torch.configs.base import InputShape, MeshConfig, ModelConfig
from repro_torch.models.moe import moe_capacity


def _attn_flops_per_token(cfg: ModelConfig, ctx: int) -> float:
    """Projections + score/PV terms against a ctx-length context."""
    a = cfg.attention
    d = cfg.d_model
    proj = 2 * d * (a.n_heads + 2 * a.n_kv_heads) * a.head_dim \
        + 2 * a.n_heads * a.head_dim * d
    scores = 4 * ctx * a.n_heads * a.head_dim  # QK^T + PV, as-written (full S)
    return proj + scores


def _mlp_flops_per_token(cfg: ModelConfig) -> float:
    return 2 * 3 * cfg.d_model * cfg.d_ff


def _moe_flops_per_token(cfg: ModelConfig, n_tokens: int) -> float:
    m = cfg.moe
    d = cfg.d_model
    router = 2 * d * m.n_experts
    C = moe_capacity(n_tokens, m, m.capacity_factor)
    # Capacity GEMMs process E*C rows regardless of fill: per-token share.
    expert_rows = m.n_experts * C / max(n_tokens, 1)
    experts = expert_rows * 2 * 3 * d * m.d_ff_expert
    shared = 2 * 3 * d * m.shared_expert_d_ff if m.shared_expert_d_ff else 0
    return router + experts + shared


def _ssm_flops_per_token(cfg: ModelConfig) -> float:
    s = cfg.ssm
    d = cfg.d_model
    d_in = s.expand * d
    if s.kind == "mamba1":
        rank = max(d // 16, 1)
        proj = 2 * d * 2 * d_in + 2 * d_in * (rank + 2 * s.d_state) \
            + 2 * rank * d_in + 2 * d_in * d
        scan = 10 * d_in * s.d_state  # exp, recurrence, output dot
        conv = 2 * s.d_conv * d_in
        return proj + scan + conv
    H = d_in // s.head_dim
    P = s.head_dim
    N = s.d_state
    L = s.chunk
    proj = 2 * d * (2 * d_in + 2 * s.n_groups * N + H) + 2 * d_in * d
    conv = 2 * s.d_conv * (d_in + 2 * s.n_groups * N)
    # SSD per token: scores 2LN + intra 2LHP + states/inter ~4NHP.
    ssd = 2 * L * N + 2 * L * H * P + 4 * N * H * P
    return proj + conv + ssd


def _shared_block_flops_per_token(cfg: ModelConfig, ctx: int) -> float:
    d = cfg.d_model
    proj = 8 * d * d  # qkvo at full MHA heads
    scores = 4 * ctx * d
    return proj + scores + 2 * 3 * d * 4 * d  # + 4d GLU mlp


def flops_per_token(cfg: ModelConfig, ctx: int, n_tokens_for_moe: int) -> float:
    per_layer = 0.0
    if cfg.mixer == "attention":
        per_layer += _attn_flops_per_token(cfg, ctx)
    else:
        per_layer += _ssm_flops_per_token(cfg)
    if cfg.mlp == "dense":
        per_layer += _mlp_flops_per_token(cfg)
    elif cfg.mlp == "moe":
        per_layer += _moe_flops_per_token(cfg, n_tokens_for_moe)
    total = per_layer * cfg.n_layers
    if cfg.shared_attn_every:
        n_shared = cfg.n_layers // cfg.shared_attn_every
        total += n_shared * _shared_block_flops_per_token(cfg, ctx)
    n_heads_out = cfg.modality.n_codebooks if (
        cfg.modality and cfg.modality.kind == "audio") else 1
    total += 2 * cfg.d_model * cfg.vocab_size * n_heads_out  # logits
    return total


def analytic_costs(
    cfg: ModelConfig, shape: InputShape, mesh_cfg: MeshConfig, V: int = 1,
    param_bytes: int = 4, attn_ctx_factor: float = 1.0,
) -> Dict:
    """Global FLOPs + per-device HBM bytes + per-device in-loop collective
    wire bytes for one jitted call of the (arch x shape) pair."""
    n_dev = mesh_cfg.n_devices
    msize = 16  # model-axis size on both meshes
    total_p, active_p = cfg.param_count()
    B, S = shape.global_batch, shape.seq_len
    window = cfg.attention.sliding_window if cfg.attention else None

    if shape.kind == "train":
        tokens = B * S * V
        ctx = min(S, window) if window else S
        ctx = max(int(ctx * attn_ctx_factor), 1)
        f = flops_per_token(cfg, ctx, B * S) * tokens
        f *= 4.0 if cfg.remat else 3.0  # fwd + bwd(2x) [+ remat re-fwd]
        # HBM: V local steps each stream params 3x (fwd/bwd/update) + acts.
        # Each device holds ONE client's model-shard: total_p / msize.
        p_dev = total_p * param_bytes / msize
        act = tokens / (n_dev / msize) * cfg.d_model * 2 * cfg.n_layers * 6
        hbm_dev = V * 4 * p_dev + act
        # In-loop TP collectives: 2 activation all-reduces per layer per pass,
        # 3 passes (fwd/bwd/remat), over the model axis.
        act_bytes = tokens / (n_dev / msize) * cfg.d_model * 2
        coll_inloop_dev = (2 * cfg.n_layers * 3 * 2 * act_bytes
                           * (msize - 1) / msize) / msize
    elif shape.kind == "prefill":
        tokens = B * S
        ctx = min(S, window) if window else S
        ctx = max(int(ctx * attn_ctx_factor), 1)
        f = flops_per_token(cfg, ctx, tokens)
        f *= tokens
        p_dev = total_p * param_bytes / msize
        act = tokens / (n_dev / msize) * cfg.d_model * 2 * cfg.n_layers * 4
        kv = 0
        if cfg.attention:
            a = cfg.attention
            L = min(S, window) if window else S
            kv = B * L * a.n_kv_heads * a.head_dim * 2 * 2 * cfg.n_layers / n_dev
        hbm_dev = p_dev + act + kv
        act_bytes = tokens / (n_dev / msize) * cfg.d_model * 2
        coll_inloop_dev = (2 * cfg.n_layers * act_bytes
                           * (msize - 1) / msize) / msize
    else:  # decode: one token against the cache
        tokens = B
        ctx = min(S, window) if window else S
        f = flops_per_token(cfg, ctx, tokens) * tokens
        p_dev = total_p * param_bytes / msize  # all params stream per step
        kv = 0.0
        if cfg.attention:
            a = cfg.attention
            L = min(S, window) if window else S
            kv = B * L * a.n_kv_heads * a.head_dim * 2 * 2 * cfg.n_layers
        if cfg.ssm:
            d_in = cfg.ssm.expand * cfg.d_model
            kv += B * d_in * cfg.ssm.d_state * 4 * cfg.n_layers * 2
        hbm_dev = p_dev + kv / n_dev  # cache sharded batch x model
        act_bytes = tokens * cfg.d_model * 2
        coll_inloop_dev = (2 * cfg.n_layers * act_bytes
                           * (msize - 1) / msize) / msize

    return {
        "flops_global": float(f),
        "flops_per_device": float(f / n_dev),
        "hbm_bytes_per_device": float(hbm_dev),
        "collective_inloop_wire_bytes_per_device": float(coll_inloop_dev),
        "tokens": int(tokens),
    }


def analytic_flops_as_run(cfg: ModelConfig, shape: InputShape,
                          mesh_cfg: MeshConfig, V: int = 1) -> float:
    """`analytic_costs`' global FLOPs for the step the port's dry run runs
    (launch/dryrun.py), which differs from the model's by construction in
    four places (everything else is equal term for term):

    - prefill computes logits at the last position of each sequence only
      (in both packages); the model counts them at every token;
    - a vision model's projector (prefix_embeds @ w) is outside the model:
      2·e·d a prefix token forward, and the weight gradient's as much
      again in training (the embeddings take none);
    - a mamba2 decode step has no chunk: the model's intra-chunk SSD terms
      (2·L·N + 2·L·H·P a token, L = ssm.chunk) are not run;
    - training is one client's step scaled by V and C: the MoE capacity
      is sized on its b·S routed tokens (the model: B·S), and there is no
      remat (forward + 2x backward, the model's 3x; its 4x with remat).
    """
    B, S = shape.global_batch, shape.seq_len
    m = cfg.modality
    if shape.kind == "train":
        window = cfg.attention.sliding_window if cfg.attention else None
        ctx = min(S, window) if window else S
        b = B // mesh_cfg.n_clients
        f = flops_per_token(cfg, ctx, b * S) * B * S * V * 3.0
    else:
        f = analytic_costs(cfg, shape, mesh_cfg, V=1)["flops_global"]
    if shape.kind == "prefill":
        K = m.n_codebooks if (m and m.kind == "audio") else 1
        f -= (B * S - B) * 2 * cfg.d_model * cfg.vocab_size * K
    if m and m.kind != "audio" and shape.kind != "decode":
        proj = B * m.prefix_len * 2 * m.embed_dim * cfg.d_model
        f += proj * (2 * V if shape.kind == "train" else 1)
    if shape.kind == "decode" and cfg.mixer == "mamba2":
        s = cfg.ssm
        H = s.expand * cfg.d_model // s.head_dim
        f -= (cfg.n_layers * B
              * (2 * s.chunk * s.d_state + 2 * s.chunk * H * s.head_dim))
    return float(f)
