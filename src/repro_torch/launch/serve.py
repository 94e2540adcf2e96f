"""Batched serving driver: prefill a batch of prompts, then decode tokens
greedily step by step against the layers' caches. Port of
repro/launch/serve.py for every arch the port serves
(configs/registry.py): qwen2-0.5b, falcon-mamba-7b, gemma-7b, zamba2-2.7b
and musicgen-large.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-0.5b \
      --batch 4 --prompt-len 2048 --gen 32
  PYTHONPATH=src python -m repro_torch.launch.serve --arch musicgen-large \
      --smoke --device cpu

Runs on the CUDA card unless `--device cpu` is given. The prefill goes
through the hand-written kernels (impl="kernel"): flash attention for the
attention archs and zamba2-2.7b's shared block, the selective scan for
falcon-mamba-7b; on CPU tensors their wrappers run the plain versions.
Decode is plain torch. An audio model (musicgen-large) takes prompts of
(B, S, K) codebook tokens and generates (B, gen, K); as in the
reference's `main`, no conditioning prefix is passed (`generate` takes
one). The weights are random, drawn on the CPU from `--seed` one layer at
a time, so every device serves the same model (falcon-mamba-7b's 7.0e9
float32 parameters take 28 GB on the card; in scripts draw them from a
CUDA generator).
"""
from __future__ import annotations

import argparse
import time
from dataclasses import dataclass

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.registry import get_config
from repro_torch.device import resolve_device
from repro_torch.models import transformer as tfm
from repro_torch.utils.tree import leaves


@dataclass
class Generation:
    # (B, gen) int64 greedy tokens, the first from prefill; (B, gen, K) audio
    tokens: torch.Tensor
    # float32 logits of the last prompt position: (B, 1, V), (B, 1, K, V)
    prefill_logits: torch.Tensor
    last_logits: torch.Tensor  # float32, of the last step run, as above
    prefill_s: float  # host seconds, ending in a device sync
    decode_s: float  # host seconds for the gen - 1 decode steps


def make_prompts(cfg: ModelConfig, batch: int, prompt_len: int, seed: int,
                 ) -> torch.Tensor:
    """(batch, prompt_len) int64 token ids, or (batch, prompt_len, K) for
    an audio model, drawn on the CPU from `seed`."""
    gen = torch.Generator().manual_seed(seed)
    K = tfm.codebooks(cfg)
    shape = (batch, prompt_len, K) if K else (batch, prompt_len)
    return torch.randint(0, cfg.vocab_size, shape, generator=gen)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def generate(cfg: ModelConfig, params, prompts: torch.Tensor, gen: int,
             impl: str = "kernel", device=None, prefix_embeds=None,
             ) -> Generation:
    """Prefill `prompts` (B, S), or (B, S, K) for audio, after an optional
    modality prefix (B, P, embed_dim), then decode until `gen` tokens a
    prompt (greedy argmax, each codebook's own for audio). `params` must
    lie on `device` (cuda unless "cpu" is asked for); the prompts and the
    prefix are moved there."""
    if gen < 1:
        raise ValueError(f"gen must be >= 1, got {gen}")
    dev = resolve_device(device)
    for t in leaves(params):
        if t.device.type != dev.type:
            raise ValueError(f"params on {t.device}, generate runs on {dev}")
    prompts = prompts.to(dev)
    if prefix_embeds is not None:
        prefix_embeds = prefix_embeds.to(dev)
    B, S = prompts.shape[:2]
    P = 0 if prefix_embeds is None else prefix_embeds.shape[1]
    tok_shape = (B, 1, *prompts.shape[2:])

    t0 = time.perf_counter()
    logits, cache = tfm.prefill(cfg, params, prompts, max_len=P + S + gen,
                                impl=impl, prefix_embeds=prefix_embeds)
    _sync(dev)
    prefill_s = time.perf_counter() - t0
    prefill_logits = logits

    tok = logits[:, -1].argmax(dim=-1).reshape(tok_shape)
    out = [tok]
    t0 = time.perf_counter()
    for _ in range(gen - 1):
        logits, cache = tfm.decode_step(cfg, params, cache, tok)
        tok = logits[:, 0].argmax(dim=-1).reshape(tok_shape)
        out.append(tok)
    _sync(dev)
    decode_s = time.perf_counter() - t0
    return Generation(torch.cat(out, dim=1), prefill_logits, logits,
                      prefill_s, decode_s)


def main(argv=None) -> torch.Tensor:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, smoke=args.smoke)
    dev = resolve_device(args.device)
    params = tfm.init_params(cfg, torch.Generator().manual_seed(args.seed),
                             device=dev)
    prompts = make_prompts(cfg, args.batch, args.prompt_len, args.seed)
    res = generate(cfg, params, prompts, args.gen, device=dev)
    B, S = prompts.shape[:2]
    print(f"prefill: {B}x{S} tokens in {res.prefill_s:.2f}s "
          f"({B * S / res.prefill_s:.0f} tok/s)")
    steps = args.gen - 1
    print(f"decode: {steps} steps x {B} seqs in {res.decode_s:.2f}s "
          f"({steps * B / max(res.decode_s, 1e-9):.1f} tok/s)")
    toks = res.tokens.cpu()
    print(f"generated shape: {tuple(toks.shape)}; first row: "
          f"{toks[0].reshape(-1)[:16].tolist()}")
    return toks


if __name__ == "__main__":
    main()
