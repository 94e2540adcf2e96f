"""Batched serving driver: prefill a batch of prompts, then decode tokens
greedily step by step against the layers' caches. Port of
repro/launch/serve.py for the archs the port serves
(configs/registry.py): qwen2-0.5b and falcon-mamba-7b.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-0.5b \
      --batch 4 --prompt-len 2048 --gen 32
  PYTHONPATH=src python -m repro_torch.launch.serve --arch falcon-mamba-7b \
      --batch 4 --prompt-len 2048 --gen 32

Runs on the CUDA card unless `--device cpu` is given. The prefill goes
through the hand-written kernels (impl="kernel"): flash attention for
qwen2-0.5b, the selective scan for falcon-mamba-7b; on CPU tensors their
wrappers run the plain versions. Decode is plain torch. The weights are
random, drawn on the CPU from `--seed` one layer at a time, so every
device serves the same model (falcon-mamba-7b's 7.0e9 float32 parameters
take 28 GB on the card).
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
    tokens: torch.Tensor  # (B, gen) int64: greedy tokens, the first from prefill
    prefill_logits: torch.Tensor  # (B, 1, V) float32, last prompt position
    last_logits: torch.Tensor  # (B, 1, V) float32, of the last step run
    prefill_s: float  # host seconds, ending in a device sync
    decode_s: float  # host seconds for the gen - 1 decode steps


def make_prompts(cfg: ModelConfig, batch: int, prompt_len: int, seed: int,
                 ) -> torch.Tensor:
    """(batch, prompt_len) int64 token ids, drawn on the CPU from `seed`."""
    gen = torch.Generator().manual_seed(seed)
    return torch.randint(0, cfg.vocab_size, (batch, prompt_len),
                         generator=gen)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def generate(cfg: ModelConfig, params, prompts: torch.Tensor, gen: int,
             impl: str = "kernel", device=None) -> Generation:
    """Prefill `prompts` (B, S), then decode until `gen` tokens a prompt
    (greedy argmax). `params` must lie on `device` (cuda unless "cpu" is
    asked for); the prompts are moved there."""
    if gen < 1:
        raise ValueError(f"gen must be >= 1, got {gen}")
    dev = resolve_device(device)
    for t in leaves(params):
        if t.device.type != dev.type:
            raise ValueError(f"params on {t.device}, generate runs on {dev}")
    prompts = prompts.to(dev)
    B, S = prompts.shape

    t0 = time.perf_counter()
    logits, cache = tfm.prefill(cfg, params, prompts, max_len=S + gen,
                                impl=impl)
    _sync(dev)
    prefill_s = time.perf_counter() - t0
    prefill_logits = logits

    tok = logits[:, -1].argmax(dim=-1).reshape(B, 1)
    out = [tok]
    t0 = time.perf_counter()
    for _ in range(gen - 1):
        logits, cache = tfm.decode_step(cfg, params, cache, tok)
        tok = logits[:, 0].argmax(dim=-1).reshape(B, 1)
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
    B, S = prompts.shape
    print(f"prefill: {B}x{S} tokens in {res.prefill_s:.2f}s "
          f"({B * S / res.prefill_s:.0f} tok/s)")
    steps = args.gen - 1
    print(f"decode: {steps} steps x {B} seqs in {res.decode_s:.2f}s "
          f"({steps * B / max(res.decode_s, 1e-9):.1f} tok/s)")
    toks = res.tokens.cpu()
    print(f"generated shape: {tuple(toks.shape)}; first row: "
          f"{toks[0, :16].tolist()}")
    return toks


if __name__ == "__main__":
    main()
