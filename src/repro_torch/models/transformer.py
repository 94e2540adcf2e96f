"""The decoder stack of the LLM zoo: the attention, mamba1 and mamba2
mixers with a dense or mixture-of-experts channel mixer or none, zamba2's
tied shared attention block, the modality prefix (precomputed frame or
patch embeddings through a linear projector) and musicgen's K summed
codebook embeddings with K untied LM heads. Port of
repro/models/transformer.py.

Layer parameters are stacked (n_groups, scan_group, ...) as in the
reference, so its parameters carry over as a plain copy (convert.py). A
Python loop over the layers replaces the reference's `lax.scan` and remat
(PyTorch runs eagerly; training keeps every layer's activations for
autograd). With `shared_attn_every` set, one shared block (attention +
MLP, parameters `params["shared"]`) runs after each scan group, as in the
reference, with a KV cache of its own for each group (`cache["shared"]`).
`loss_fn` is the reference's next-token cross-entropy on the text (or
codebook) positions plus the MoE router's aux loss summed over the layers.
Prefill and decode run the MoE at the config's capacity factor and drop
its metrics, as the reference does.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import AttentionConfig, ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import mamba as m1
from repro_torch.models import mamba2 as m2
from repro_torch.models.mlp import init_mlp, mlp_forward
from repro_torch.models.moe import init_moe, moe_forward
from repro_torch.models.norms import init_rms_norm, rms_norm
from repro_torch.utils.tree import tree_map

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def check_supported(cfg: ModelConfig) -> None:
    """Raises NotImplementedError for the parts of `cfg` the port does not
    run yet."""
    todo = []
    if cfg.mixer not in ("attention", "mamba1", "mamba2"):
        todo.append(f"the {cfg.mixer!r} mixer")
    if cfg.mlp not in ("dense", "moe", "none"):
        todo.append(f"the {cfg.mlp!r} channel mixer")
    if cfg.dtype not in _DTYPES:
        todo.append(f"dtype {cfg.dtype!r}")
    if todo:
        raise NotImplementedError(
            f"{cfg.name}: not yet ported to repro_torch: " + "; ".join(todo))


def shared_attn_cfg(cfg: ModelConfig) -> AttentionConfig:
    """The shared block's attention (the reference's `_shared_attn_cfg`):
    MHA of `shared_attn_heads` heads of d_model / heads each (zamba2-2.7b:
    32 heads of 80)."""
    hd = cfg.d_model // cfg.shared_attn_heads
    return AttentionConfig(n_heads=cfg.shared_attn_heads,
                           n_kv_heads=cfg.shared_attn_heads, head_dim=hd)


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def _init_layer(cfg: ModelConfig, gen: torch.Generator) -> Dict:
    p: Dict = {"ln1": init_rms_norm(cfg.d_model, device=gen.device)}
    if cfg.mixer == "attention":
        p["attn"] = attn.init_attention(gen, cfg.d_model, cfg.attention)
    elif cfg.mixer == "mamba1":
        p["mamba"] = m1.init_mamba1(gen, cfg.d_model, cfg.ssm)
    else:
        p["mamba"] = m2.init_mamba2(gen, cfg.d_model, cfg.ssm)
    if cfg.mlp == "dense":
        p["ln2"] = init_rms_norm(cfg.d_model, device=gen.device)
        p["mlp"] = init_mlp(gen, cfg.d_model, cfg.d_ff)
    elif cfg.mlp == "moe":
        p["ln2"] = init_rms_norm(cfg.d_model, device=gen.device)
        p["moe"] = init_moe(gen, cfg.d_model, cfg.moe)
    return p


def codebooks(cfg: ModelConfig) -> int:
    """K, the parallel codebooks of an audio model (musicgen-large: 4), or
    0 for a text model."""
    m = cfg.modality
    return m.n_codebooks if m and m.kind == "audio" else 0


def init_params(cfg: ModelConfig, gen: torch.Generator, device=None) -> Dict:
    """Random float32 parameters in the reference's layout, drawn from
    `gen` on its device and moved to `device` (cuda unless "cpu" is asked
    for). The values differ from the reference's (torch's generator is not
    JAX's threefry); the shapes, scales and tree equal its `init_params`:
    an audio model's embedding is (K, V, d), a modality adds the projector
    {"w": (embed_dim, d), "b": (d,)}, and an untied head is `lm_head` (d,
    V), or (K, d, V) for audio. Drawn in this order: the embedding, the
    projector, the layers, the shared block, the LM head.

    Each stacked (G, sg, ...) layer leaf is allocated on `device` first and
    the layers, drawn one at a time in order, are copied into their
    slices: the draw holds one layer beside the model, never a second copy
    of it (28 GB at falcon-mamba-7b's width)."""
    check_supported(cfg)
    dev = resolve_device(device)
    d = cfg.d_model

    def normal(shape, scale):
        return (torch.randn(shape, generator=gen, device=gen.device)
                * scale).to(dev)

    K = codebooks(cfg)
    embed_shape = (K, cfg.vocab_size, d) if K else (cfg.vocab_size, d)
    params: Dict = {"embed": normal(embed_shape, 0.02)}
    if cfg.modality:
        e = cfg.modality.embed_dim
        params["projector"] = {"w": normal((e, d), 1.0 / e ** 0.5),
                               "b": torch.zeros(d, device=dev)}
    G, sg = cfg.n_scan_groups, cfg.scan_group
    for idx in range(G * sg):
        layer = _init_layer(cfg, gen)
        if idx == 0:
            params["layers"] = tree_map(
                lambda t: torch.empty((G, sg, *t.shape), dtype=t.dtype,
                                      device=dev), layer)
        tree_map(lambda dst, src: dst.copy_(src),
                 _layer(params["layers"], cfg, idx), layer)
        del layer
    if cfg.shared_attn_every:
        params["shared"] = tree_map(lambda t: t.to(dev), {
            "ln1": init_rms_norm(d, device=gen.device),
            "attn": attn.init_attention(gen, d, shared_attn_cfg(cfg)),
            "ln2": init_rms_norm(d, device=gen.device),
            "mlp": init_mlp(gen, d, 4 * d),
        })
    params["ln_f"] = init_rms_norm(d, device=dev)
    if not cfg.tie_embeddings:
        head_shape = (K, d, cfg.vocab_size) if K else (d, cfg.vocab_size)
        params["lm_head"] = normal(head_shape, 1.0 / d ** 0.5)
    return params


# ---------------------------------------------------------------------------
# Forward (full sequence)
# ---------------------------------------------------------------------------


def _layer(params: Dict, cfg: ModelConfig, idx: int) -> Dict:
    """Layer `idx`'s parameters: a view of the stacked (G, sg, ...) leaves."""
    g, i = divmod(idx, cfg.scan_group)
    return tree_map(lambda t: t[g, i], params)


def _layer_forward(cfg: ModelConfig, p: Dict, x, positions, impl: str):
    """One block: pre-norm mixer + pre-norm channel-mixer, residuals.
    Returns (x, the MoE's aux loss or None)."""
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    if cfg.mixer == "attention":
        h = attn.attention_forward(p["attn"], h, cfg.attention, positions,
                                   impl)
    elif cfg.mixer == "mamba1":
        h = m1.mamba1_forward(p["mamba"], h, cfg.ssm, impl)
    else:
        h = m2.mamba2_forward(p["mamba"], h, cfg.ssm)
    return _channel_mix(cfg, p, x + h)


def _shared_mlp(cfg: ModelConfig, p: Dict, x):
    """The shared block's pre-norm MLP with its residual."""
    return x + mlp_forward(p["mlp"], rms_norm(x, p["ln2"], cfg.norm_eps),
                           cfg.act)


def _shared_block(cfg: ModelConfig, p: Dict, x, positions, impl: str):
    """The tied shared attention + MLP block (full sequence, no cache)."""
    x = x + attn.attention_forward(
        p["attn"], rms_norm(x, p["ln1"], cfg.norm_eps), shared_attn_cfg(cfg),
        positions, impl)
    return _shared_mlp(cfg, p, x)


def _group_end(cfg: ModelConfig, idx: int) -> Optional[int]:
    """The scan group that layer `idx` closes when a shared block follows
    it (after every group, as in the reference), else None."""
    g, i = divmod(idx, cfg.scan_group)
    return g if cfg.shared_attn_every and i == cfg.scan_group - 1 else None


def _channel_mix(cfg: ModelConfig, p: Dict, x):
    """The pre-norm dense MLP or MoE with its residual, or nothing
    (mlp="none"). Returns (x, the MoE's aux loss, or None)."""
    if cfg.mlp == "dense":
        x = x + mlp_forward(p["mlp"], rms_norm(x, p["ln2"], cfg.norm_eps),
                            cfg.act)
    elif cfg.mlp == "moe":
        h, metrics = moe_forward(p["moe"], rms_norm(x, p["ln2"], cfg.norm_eps),
                                 cfg.moe, cfg.act)
        return x + h, metrics["aux_loss"]
    return x, None


def embed_inputs(cfg: ModelConfig, params: Dict, tokens, prefix_embeds=None):
    """Token (or summed codebook) embedding with an optional projected
    modality prefix. tokens: (B, S), or (B, S, K) for audio; prefix_embeds:
    (B, P, embed_dim) or None. Returns (x, prefix_len): x (B, P + S, d) in
    cfg.dtype, the prefix first.

    The K codebook embeddings are summed in float32 in the reference's
    order, ((emb[0][t0] + emb[1][t1]) + ...), then cast: the same float32
    adds, so the sum equals the reference's exactly."""
    dtype = _DTYPES[cfg.dtype]
    emb = params["embed"]
    if codebooks(cfg):
        x = emb[0][tokens[..., 0]]
        for k in range(1, codebooks(cfg)):
            x = x + emb[k][tokens[..., k]]
        x = x.to(dtype)
    else:
        x = emb[tokens].to(dtype)
    if not cfg.modality or prefix_embeds is None:
        return x, 0
    pr = params["projector"]
    pref = (prefix_embeds.to(torch.float32) @ pr["w"] + pr["b"]).to(dtype)
    return torch.cat([pref, x], dim=1), prefix_embeds.shape[1]


def compute_logits(cfg: ModelConfig, params: Dict, x):
    """float32 logits: (B, S, V) against the tied embedding or the untied
    head, (B, S, K, V) against an audio model's K heads."""
    xf = rms_norm(x, params["ln_f"], cfg.norm_eps).to(torch.float32)
    if cfg.tie_embeddings:
        return xf @ params["embed"].to(torch.float32).T
    head = params["lm_head"]
    if head.dim() == 3:
        return torch.einsum("bsd,kdv->bskv", xf, head)
    return xf @ head


def _positions(B: int, S: int, device) -> torch.Tensor:
    return torch.arange(S, dtype=torch.int32, device=device)[None].expand(B, S)


def forward(cfg: ModelConfig, params: Dict, tokens, impl: str = "plain", *,
            prefix_embeds=None) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """Full-sequence forward over the prefix and the tokens. Returns
    (logits, aux_loss, prefix_len): the aux loss is the MoE router's
    summed over the layers in order (float32), 0 for a model without
    one."""
    check_supported(cfg)
    x, prefix_len = embed_inputs(cfg, params, tokens, prefix_embeds)
    positions = _positions(x.shape[0], x.shape[1], x.device)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for idx in range(cfg.n_layers):
        x, a = _layer_forward(cfg, _layer(params["layers"], cfg, idx), x,
                              positions, impl)
        if a is not None:
            aux = aux + a
        if _group_end(cfg, idx) is not None:
            x = _shared_block(cfg, params["shared"], x, positions, impl)
    return compute_logits(cfg, params, x), aux, prefix_len


def loss_fn(cfg: ModelConfig, params: Dict, batch: Dict, impl: str = "plain",
            ) -> Tuple[torch.Tensor, Dict]:
    """Next-token cross-entropy plus the MoE aux loss. batch:
    {"tokens": (B, S) or (B, S, K), optionally "prefix_embeds"}. Position
    P + t predicts token t + 1 (the prefix's positions predict nothing):
    the mean over (B, S - 1), or (B, S - 1, K) for audio, of -log p in
    float32. Returns (loss + aux, {"ce_loss", "aux_loss"})."""
    tokens = batch["tokens"]
    logits, aux, P = forward(cfg, params, tokens, impl,
                             prefix_embeds=batch.get("prefix_embeds"))
    logp = torch.log_softmax(logits[:, P:P + tokens.shape[1] - 1], dim=-1)
    targets = tokens[:, 1:].to(torch.int64)
    nll = -torch.gather(logp, -1, targets[..., None])[..., 0]
    loss = torch.mean(nll)
    return loss + aux, {"ce_loss": loss, "aux_loss": aux}


# ---------------------------------------------------------------------------
# Serving: prefill + decode with per-layer caches
# ---------------------------------------------------------------------------


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device=None,
               ) -> Dict:
    """Stacked per-layer caches on `device` (cuda unless "cpu" is asked
    for), and the next position `pos` as a host int. Attention: KV leaves
    (G, sg, B, L, KV, hd) in bf16. mamba1: the conv tail (G, sg, B,
    d_conv - 1, d_in) and the state h (G, sg, B, d_in, N); mamba2: the
    conv tail (G, sg, B, d_conv - 1, conv_dim) and h (G, sg, B, H, P, N),
    all float32 (`max_len` is not read). With a shared block, its G KV
    caches (G, B, L, heads, hd) in bf16 under "shared"."""
    check_supported(cfg)
    dev = resolve_device(device)
    if cfg.mixer == "attention":
        one = attn.init_kv_cache(batch, max_len, cfg.attention,
                                 device="meta")
    elif cfg.mixer == "mamba1":
        one = m1.init_mamba1_cache(batch, cfg.d_model, cfg.ssm,
                                   device="meta")
    else:
        one = m2.init_mamba2_cache(batch, cfg.d_model, cfg.ssm,
                                   device="meta")
    G, sg = cfg.n_scan_groups, cfg.scan_group
    layers = {name: torch.zeros((G, sg, *t.shape), dtype=t.dtype, device=dev)
              for name, t in one.items()}
    cache: Dict = {"layers": layers, "pos": 0}
    if cfg.shared_attn_every:
        one = attn.init_kv_cache(batch, max_len, shared_attn_cfg(cfg),
                                 device="meta")
        cache["shared"] = {
            name: torch.zeros((G, *t.shape), dtype=t.dtype, device=dev)
            for name, t in one.items()}
    return cache


def _layer_decode(cfg: ModelConfig, p: Dict, x, pos: int, layer_cache):
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    if cfg.mixer == "attention":
        h, layer_cache = attn.attention_decode_step(
            p["attn"], h, cfg.attention, pos, layer_cache)
    elif cfg.mixer == "mamba1":
        h, layer_cache = m1.mamba1_decode_step(p["mamba"], h, cfg.ssm,
                                               layer_cache)
    else:
        h, layer_cache = m2.mamba2_decode_step(p["mamba"], h, cfg.ssm,
                                               layer_cache)
    x, _ = _channel_mix(cfg, p, x + h)
    return x, layer_cache


def decode_step(cfg: ModelConfig, params: Dict, cache: Dict, tokens,
                ) -> Tuple[torch.Tensor, Dict]:
    """One-token decode. tokens: (B, 1), or (B, 1, K) for audio. Returns
    (logits (B, 1, V) or (B, 1, K, V), cache): the cache's tensors are
    updated in place and its `pos` advanced."""
    check_supported(cfg)
    x, _ = embed_inputs(cfg, params, tokens)
    pos = cache["pos"]
    for idx in range(cfg.n_layers):
        x, _ = _layer_decode(cfg, _layer(params["layers"], cfg, idx), x, pos,
                             _layer(cache["layers"], cfg, idx))
        g = _group_end(cfg, idx)
        if g is not None:
            p_s = params["shared"]
            a, _ = attn.attention_decode_step(
                p_s["attn"], rms_norm(x, p_s["ln1"], cfg.norm_eps),
                shared_attn_cfg(cfg), pos,
                tree_map(lambda t: t[g], cache["shared"]))
            x = _shared_mlp(cfg, p_s, x + a)
    cache["pos"] = pos + 1
    return compute_logits(cfg, params, x), cache


def prefill(cfg: ModelConfig, params: Dict, tokens,
            max_len: Optional[int] = None, impl: str = "plain", *,
            prefix_embeds=None) -> Tuple[torch.Tensor, Dict]:
    """Full-sequence forward over the prefix and the tokens that fills all
    caches (in place). Returns (logits of the last position, (B, 1, V) or
    (B, 1, K, V), cache). Positions run over prefix + tokens: `max_len`
    (default: their total) counts the prefix, and the cache's `pos` is the
    total length.

    A mamba prompt needs at least d_conv - 1 tokens: a shorter one would
    leave a conv tail that decode cannot use (the reference stores it all
    the same, or fails to), so it raises ValueError."""
    check_supported(cfg)
    x, _ = embed_inputs(cfg, params, tokens, prefix_embeds)
    B, S = x.shape[:2]
    if cfg.mixer != "attention" and S < cfg.ssm.d_conv - 1:
        raise ValueError(f"{cfg.name}: a prompt of {S} tokens is shorter "
                         f"than d_conv - 1 = {cfg.ssm.d_conv - 1}")
    positions = _positions(B, S, x.device)
    cache = init_cache(cfg, B, max_len or S, device=x.device)
    for idx in range(cfg.n_layers):
        p = _layer(params["layers"], cfg, idx)
        c = _layer(cache["layers"], cfg, idx)
        h = rms_norm(x, p["ln1"], cfg.norm_eps)
        if cfg.mixer == "attention":
            h, _ = attn.attention_prefill(p["attn"], h, cfg.attention,
                                          positions, c, impl)
        else:
            if cfg.mixer == "mamba1":
                h, (conv_tail, hst) = m1.mamba1_forward(
                    p["mamba"], h, cfg.ssm, impl, return_state=True)
            else:
                h, (conv_tail, hst) = m2.mamba2_forward(
                    p["mamba"], h, cfg.ssm, return_state=True)
            c["conv"].copy_(conv_tail)
            c["h"].copy_(hst)
        x, _ = _channel_mix(cfg, p, x + h)
        g = _group_end(cfg, idx)
        if g is not None:
            p_s = params["shared"]
            a, _ = attn.attention_prefill(
                p_s["attn"], rms_norm(x, p_s["ln1"], cfg.norm_eps),
                shared_attn_cfg(cfg), positions,
                tree_map(lambda t: t[g], cache["shared"]), impl)
            x = _shared_mlp(cfg, p_s, x + a)
    cache["pos"] = S
    return compute_logits(cfg, params, x[:, -1:]), cache
