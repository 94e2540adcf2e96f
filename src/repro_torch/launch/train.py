"""End-to-end federated training driver: DEFL (Algorithm 1) on a
transformer of the LLM zoo over synthetic token data. Port of
repro/launch/train.py.

M clients each run V local SGD steps from the global model on their own
token stream, FedAvg (unit weights) makes the next global model, and the
paper's delay model advances the simulated wall clock (Eq. 8) beside the
real training. With `--defl` the batch size and V come from the DEFL plan
(`defl.make_plan` on the model's update bits; the batch capped at 64).

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \\
      --smoke --rounds 20 --clients 4 --seq 128 --defl --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \\
      --clients 2 --batch 8 --seq 128 --V 2 --rounds 2 --defl

Runs on the CUDA card unless `--device cpu` is given. The loss runs with
impl="kernel": on the card every attention layer's forward is the flash
kernel, and its backward the plain version's VJP (kernels/flash_attention
ops.py); on CPU tensors the plain version runs both ways. The selective
scan has no backward, so falcon-mamba-7b trains on the CPU only (on the
card its wrapper raises). The windows are single-codebook text, as in the
reference, so an audio model (musicgen-large) raises here; `value_and_grad_fn`
and `client.make_local_update` train it on (B, S, K) batches. The weights
are random, drawn on the CPU from `--seed`, unless `run` is given params.
"""
from __future__ import annotations

import argparse
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import (ComputeConfig, FedConfig, ModelConfig,
                                      WirelessConfig)
from repro_torch.configs.registry import get_config
from repro_torch.core import defl, delay
from repro_torch.data import make_token_stream, token_batches
from repro_torch.device import resolve_device
from repro_torch.federated.client import make_local_update, stack_batches
from repro_torch.federated.server import aggregate_updates
from repro_torch.models import transformer as tfm
from repro_torch.optim import sgd
from repro_torch.utils.tree import leaves, tree_bytes, tree_map, unflatten


class TokenClientIterator:
    def __init__(self, stream, batch, seq, seed):
        self.stream, self.batch, self.seq = stream, batch, seq
        self.seed = seed
        self.step = 0

    def next_batch(self):
        self.step += 1
        toks = token_batches(self.stream, self.batch, self.seq, self.step,
                             self.seed)
        return {"tokens": toks}


def build_parser():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--clients", type=int, default=4)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--V", type=int, default=0, help="0 = derive from theta")
    ap.add_argument("--defl", action="store_true",
                    help="optimize (b, theta) with the DEFL KKT plan")
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    return ap


def grads_of(loss: torch.Tensor, params: List[torch.Tensor]):
    """d loss / d each of `params`, zeros for one the loss does not use (a
    modality model's projector without a prefix), as JAX gives."""
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    return [torch.zeros_like(p) if g is None else g
            for p, g in zip(params, grads)]


def value_and_grad_fn(cfg: ModelConfig, impl: str = "kernel"):
    """The loss's stacked value_and_grad(params_N, batch_N) -> (grads_N,
    loss (N,)) that client.make_local_update takes: each row's
    `tfm.loss_fn` and its gradient by autograd, row by row (a client's
    update is one row)."""

    def value_and_grad(params_n, batch_n):
        grads, losses = [], []
        for n in range(leaves(batch_n)[0].shape[0]):
            p = tree_map(lambda t: t[n].detach().requires_grad_(True),
                         params_n)
            loss, _ = tfm.loss_fn(cfg, p, tree_map(lambda b: b[n], batch_n),
                                  impl)
            grads.append(grads_of(loss, leaves(p)))
            losses.append(loss.detach())
        stacked = [torch.stack(gs) for gs in zip(*grads)]
        return unflatten(params_n, stacked), torch.stack(losses)

    return value_and_grad


@dataclass
class TrainResult:
    params: Dict  # the global model after the last round
    plan_line: Optional[str]  # the printed DEFL plan line (with --defl)
    losses: List[np.ndarray] = field(default_factory=list)  # (M, V) a round
    sim_time: List[float] = field(default_factory=list)  # Eq. 8 clock
    wall_s: List[float] = field(default_factory=list)  # host s a round


class Trainer:
    """The driver between rounds: the plan, the clients' token iterators
    and optimizer states, the Eq. 8 clock, and `result`, which each
    `run_round` extends (and prints a line for).

    `params` is a tree on the run's device (e.g. the reference's
    init_params through convert.to_torch); None draws init_params on the
    CPU from --seed and moves them there. `cfg` replaces --arch's config
    (e.g. with a float32 variant of it)."""

    def __init__(self, args: argparse.Namespace,
                 params: Optional[Dict] = None,
                 cfg: Optional[ModelConfig] = None):
        cfg = cfg or get_config(args.arch, smoke=args.smoke)
        if cfg.modality:
            # As in the reference, whose windows have no codebook axis.
            raise ValueError(
                f"{cfg.name}: the token stream has one codebook and no "
                f"prefix; train a modality model through tfm.loss_fn on "
                f"(B, S, K) batches")
        self.args, self.cfg = args, cfg
        self.device = dev = resolve_device(args.device)
        if params is None:
            params = tfm.init_params(
                cfg, torch.Generator().manual_seed(args.seed), device=dev)
        for t in leaves(params):
            if t.device.type != dev.type:
                raise ValueError(f"params on {t.device}, the run is on {dev}")
        update_bits = tree_bytes(params) * 8
        fed, plan_line = plan_fed(args, update_bits)
        if plan_line is not None:
            print(plan_line)
        self.V = args.V or fed.local_rounds
        streams = [make_token_stream(200_000, cfg.vocab_size,
                                     seed=args.seed + i)
                   for i in range(args.clients)]
        self.iters = [TokenClientIterator(s, min(fed.batch_size, 64),
                                          args.seq, seed=i)
                      for i, s in enumerate(streams)]
        opt = sgd(fed.lr)
        self.local_update = make_local_update(value_and_grad_fn(cfg), opt)
        self.opt_states = [opt.init(params) for _ in range(args.clients)]
        pop = population(args)
        self.T_cm = delay.round_comm_time(update_bits, WirelessConfig(),
                                          pop.p, pop.h)
        self.T_cp = delay.round_compute_time(fed.batch_size, pop.G, pop.f)
        self.result = TrainResult(params=params, plan_line=plan_line)

    def run_round(self) -> None:
        """One round: every client's V local steps from the global model,
        FedAvg of their deltas (unit weights), the clock advanced."""
        res, M, dev = self.result, self.args.clients, self.device
        params = res.params
        t0 = time.time()
        deltas, losses, loss_rows = [], [], []
        for m in range(M):
            batches = tree_map(
                lambda b: torch.as_tensor(b, dtype=torch.int64, device=dev),
                stack_batches([self.iters[m].next_batch()
                               for _ in range(self.V)]))
            new_p, self.opt_states[m], loss_v = self.local_update(
                params, self.opt_states[m], batches)
            deltas.append(tree_map(lambda n, g: n - g, new_p, params))
            del new_p
            loss_rows.append(loss_v.cpu().numpy())
            losses.append(float(torch.mean(loss_v)))
        res.params = aggregate_updates(params, deltas, np.ones(M))
        del deltas, params
        sim_time = (res.sim_time[-1] if res.sim_time else 0.0) + \
            delay.round_time(self.T_cm, self.T_cp, self.V)
        wall = time.time() - t0
        res.losses.append(np.stack(loss_rows))
        res.sim_time.append(sim_time)
        res.wall_s.append(wall)
        print(f"round {len(res.sim_time):3d}  loss={np.mean(losses):.4f}  "
              f"sim_time={sim_time:9.2f}s  wall={wall:6.2f}s", flush=True)


def population(args: argparse.Namespace):
    return delay.draw_population(args.clients, ComputeConfig(),
                                 WirelessConfig(), args.seed,
                                 heterogeneity=0.2)


def plan_fed(args: argparse.Namespace, update_bits: int):
    """(the run's FedConfig, the DEFL plan line or None): with --defl the
    plan's b* (capped at 64) and V, on the host (numpy only)."""
    fed = FedConfig(n_devices=args.clients, batch_size=args.batch,
                    lr=args.lr, seed=args.seed)
    if not args.defl:
        return fed, None
    plan = defl.make_plan(fed, population(args), update_bits)
    fed = defl.plan_to_fedconfig(plan, fed)
    # Practical caps for the smoke-scale driver.
    fed = type(fed)(**{**fed.__dict__, "batch_size": min(fed.batch_size, 64)})
    return fed, (f"DEFL plan: b*={plan.b} theta*={plan.theta:.4f} "
                 f"V={plan.V} H_pred={plan.H_pred:.1f} "
                 f"T_round={plan.T_round:.3f}s")


def run(argv=None, params: Optional[Dict] = None,
        cfg: Optional[ModelConfig] = None) -> TrainResult:
    """The driver on `argv` (main's flags), from `params` and `cfg` when
    given (see Trainer). Prints the plan line and one line a round."""
    trainer = Trainer(build_parser().parse_args(argv), params, cfg)
    for _ in range(trainer.args.rounds):
        trainer.run_round()
    return trainer.result


def main(argv=None):
    return run(argv).params


if __name__ == "__main__":
    main()
