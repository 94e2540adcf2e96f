#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

  python3 chip_smoke.py

Phases (each prints its own lines; any failure exits non-zero):
  1. device: the card's name and power limit (nvidia-smi), torch and CUDA
     versions;
  2. build: every CUDA kernel of the port, compiled with nvcc from the
     sources in this checkout, timed;
  3. kernels: each kernel against its plain PyTorch version on the card,
     on several cases and at the main path's shapes (exact equality
     required), then its time per launch beside the plain version's time
     and the card's bound for the same work;
  4. main path: the registered `mnist_paper` experiment with int8 uplink
     compression (the paper's MNIST CNN, M=10 clients), built on the card
     and run for 6 rounds in two chunks; every kernel must have launched
     on it (one quantize launch per round), losses must be finite and the
     uplink bits exact; then 36 more rounds timed in steady state (12
     chunks of 3, no eval) and 3 under torch.profiler (device busy share, kernels by device time);
  5. reference: `mnist_smoke` with compression on the card and on the CPU
     (the CPU run takes the kernels' plain versions) from the same model
     and the same quantizer noise; the runs must agree.

The last lines are the kernels' JSON record, the card's name and power
limit, and {"ok": true, "device": {...}}. The script exits non-zero
without a result when no CUDA card is available or the port's package
is missing.
"""
import dataclasses
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

# The H100 SXM's published device-memory rate and float32 (non-tensor-core)
# peak, for the bound of a kernel's work.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12


def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return res.stdout.strip().splitlines()[0]


def time_ms(fn, warmup=5, calls=20, reps=10):
    """Device time per call: CUDA events around `calls` back-to-back calls
    (so the host's enqueue cost hides behind the device's work), median
    over `reps` such runs after warm-up."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def profile_rounds(sim, state, rounds):
    """Run `rounds` more rounds under torch.profiler: (state', wall s,
    device-busy s, [(kernel, device s)] by device time). Only device-side
    events count (a CPU op's device time repeats its kernels')."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, _ = sim.run(state, max_rounds=rounds, eval_every=rounds)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_name = {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        by_name[e.key] = by_name.get(e.key, 0.0) + us * 1e-6
    top = sorted(by_name.items(), key=lambda kv: -kv[1])
    return state, wall, sum(by_name.values()), top


def quantize_cases(dev):
    import torch
    g = torch.Generator().manual_seed(0)
    cases = {}
    for mag in (1e-6, 1e-2, 1.0, 1e3):
        cases[f"random_{mag:g}"] = torch.randn(512, 1024, generator=g) * mag
    zero = torch.randn(64, 1024, generator=g)
    zero[[0, 7, 63]] = 0.0
    cases["all_zero_rows"] = zero
    ties = torch.randn(64, 1024, generator=g)
    ties[:, 5], ties[:, 900] = 3.5, -3.5
    cases["tied_absmax"] = ties
    cases["rows_300_not_multiple_of_256"] = torch.randn(300, 1024, generator=g)
    bad = torch.randn(4, 1024, generator=g)
    bad[0, 3], bad[1, 10], bad[2, 0] = float("nan"), float("inf"), -float("inf")
    cases["non_finite_rows"] = bad
    # The main path's shape: 10 clients x 1,628 rows of 1024 per round.
    cases["slice_16280x1024"] = torch.randn(16280, 1024, generator=g) * 1e-3
    return {k: v.to(dev) for k, v in cases.items()}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false: this script "
              "needs an NVIDIA card", file=sys.stderr)
        return 1
    from repro_torch.device import resolve_device
    from repro_torch.federated import compression, experiment
    from repro_torch.kernels.quantize import ops, ref
    from repro_torch.utils.tree import leaves

    # -- 1. device ---------------------------------------------------------
    card = card_line()
    dev = resolve_device("cuda")
    print(f"[device] {card} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | {torch.cuda.get_device_name(0)} | "
          f"count {torch.cuda.device_count()} | tf32 matmul "
          f"{torch.backends.cuda.matmul.allow_tf32} cudnn "
          f"{torch.backends.cudnn.allow_tf32}", flush=True)

    # -- 2. build ----------------------------------------------------------
    t0 = time.perf_counter()
    _, log = ops.load_kernel()
    print(f"[build] quantize.cu built in {time.perf_counter() - t0:.2f} s",
          flush=True)
    for line in log.splitlines():
        if "registers" in line or "spill" in line or "error" in line:
            print(f"[build]   {line.strip()}")

    # -- 3. kernels against their plain versions -------------------------
    max_err = 0.0
    cases = quantize_cases(dev)
    for name, x in cases.items():
        u = ref.stochastic_noise(
            torch.Generator(device=dev).manual_seed(len(name)), x.shape)
        q, s = ops.quantize(x, u)
        torch.cuda.synchronize()
        q_r, s_r = ref.quantize_ref(x, u)
        bad_q = int((q != q_r).sum())
        bad_s = int((s != s_r).sum())
        max_err = max(
            max_err,
            float((q.to(torch.int32) - q_r.to(torch.int32)).abs().max()),
            # equal infinite scales (an Inf row) differ by 0, not NaN
            float(torch.where(s == s_r, 0.0, (s - s_r).abs()).max()))
        print(f"[kernel] quantize {name} {tuple(x.shape)}: "
              f"{bad_q} code and {bad_s} scale mismatches", flush=True)
        if bad_q or bad_s:
            raise SystemExit(f"quantize kernel disagrees on {name}")
    x = cases["slice_16280x1024"]
    u = ref.stochastic_noise(torch.Generator(device=dev).manual_seed(1),
                             x.shape)
    ms = time_ms(lambda: ops.quantize(x, u))
    plain_ms = time_ms(lambda: ref.quantize_ref(x, u))
    R, D = x.shape
    # x and u read once (float32), codes written once (int8), one scale a row
    n_bytes = R * D * (4 + 4 + 1) + R * 4
    n_ops = 7 * R * D  # abs, max, divide, add, floor, two-sided clamp
    bound_s = n_bytes / HBM_BYTES_PER_S
    bound_by = "bytes" if bound_s >= n_ops / FP32_OPS_PER_S else "operations"
    bound_ms = max(bound_s, n_ops / FP32_OPS_PER_S) * 1e3
    print(f"[kernel] quantize {R}x{D} on {card}: kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}: "
          f"{n_bytes / 1e6:.1f} MB), {bound_ms / ms:.1%} of bound",
          flush=True)

    # -- 4. main path --------------------------------------------------------
    spec = experiment.get("mnist_paper")
    spec = spec.replace(fed=dataclasses.replace(spec.fed,
                                                compress_updates=True))
    plan = spec.resolve_plan()
    print(f"[slice] plan: b*={plan.b} theta*={plan.theta:.4f} V={plan.V} "
          f"H_pred={plan.H_pred:.2f} T_round={plan.T_round:.4f}s "
          f"overall_pred={plan.overall_pred:.2f}s", flush=True)
    sim = spec.build()
    if sim.device.type != "cuda":
        raise SystemExit(f"the main path was built on {sim.device}")
    state = sim.init()
    rows = compression.n_rows(sim.params(state))
    bits = compression.compressed_bits(sim.params(state))
    ops.launches = 0
    t0 = time.perf_counter()
    state, res = sim.run(state, max_rounds=6, eval_every=3)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = {"quantize": ops.launches}
    for r in res.history:
        print(f"[slice] round {r.round}: sim_time={r.sim_time:.6f}s "
              f"train_loss={r.train_loss:.6f} uplink_bits={r.uplink_bits:.0f}"
              + (f" test_acc={r.test_acc:.4f}" if r.test_acc is not None
                 else ""))
    print(f"[slice] {elapsed / len(res.history):.4f} s per round "
          f"({len(res.history)} rounds, first-chunk warm-up included), "
          f"{rows} rows per client update, launches {launches}", flush=True)
    if launches["quantize"] != len(res.history):
        raise SystemExit(f"expected one quantize launch per round, got "
                         f"{launches['quantize']} in {len(res.history)}")
    if not all(math.isfinite(r.train_loss) for r in res.history):
        raise SystemExit("non-finite train loss on the main path")
    want_bits = sim.fed.n_devices * bits
    if any(r.uplink_bits != want_bits for r in res.history):
        raise SystemExit(f"uplink bits differ from {want_bits}")
    if not all(bool(torch.isfinite(p).all()) for p in leaves(res.params)):
        raise SystemExit("non-finite parameters after the main path")
    # Steady state: 12 more chunks of 3 rounds, each timed alone on the
    # host's clock (a chunk ends in its loss fetch, so the device is done),
    # with no test eval inside the timed spans.
    per_round = []
    for _ in range(12):
        t0 = time.perf_counter()
        state, _ = sim.run_chunk(state, 3)
        per_round.append((time.perf_counter() - t0) / 3)
    print(f"[slice] steady state: median {statistics.median(per_round)!r} s "
          f"per round, min {min(per_round)!r}, max {max(per_round)!r} (12 "
          f"chunks of 3 rounds, no eval; host-bound, varies by machine)",
          flush=True)
    state, wall, busy, top = profile_rounds(sim, state, 3)
    print(f"[slice] profiled 3 rounds: wall {wall:.4f} s, device busy "
          f"{busy:.4f} s ({busy / wall:.1%}; idle {1 - busy / wall:.1%}), "
          "profiler on", flush=True)
    for name, sec in top[:8]:
        print(f"[slice]   {sec / 3 * 1e3:9.3f} ms/round {sec / busy:6.1%}  "
              f"{name[:90]}")
    q_sec = sum(sec for name, sec in top if "quantize_rows" in name)
    print(f"[slice]   quantize kernel: {q_sec / 3 * 1e3:.3f} ms/round, "
          f"{q_sec / busy:.1%} of device time", flush=True)

    # -- 5. against the plain versions on the CPU, on a small input ----------
    smoke = experiment.get("mnist_smoke")
    smoke = smoke.replace(fed=dataclasses.replace(smoke.fed,
                                                  compress_updates=True))
    out = {}
    for d in ("cuda", "cpu"):
        noise_gen = torch.Generator().manual_seed(7)

        def noise(_generator, shape, d=d, noise_gen=noise_gen):
            return ref.stochastic_noise(noise_gen, shape).to(d)

        s = smoke.build(device=d, noise=noise)
        _, r = s.run(s.init(), max_rounds=3, eval_every=2)
        out[d] = r
    losses = [[h.train_loss for h in out[d].history] for d in ("cuda", "cpu")]
    worst_loss = max(abs(a - b) / abs(b) for a, b in zip(*losses))
    worst_param = max(
        float((a.cpu() - b).abs().max())
        for a, b in zip(leaves(out["cuda"].params), leaves(out["cpu"].params)))
    print(f"[reference] mnist_smoke cuda vs cpu: losses {losses[0]} vs "
          f"{losses[1]}, max rel loss gap {worst_loss:.2e}, max param gap "
          f"{worst_param:.2e}", flush=True)
    # Same tolerances as tests/test_torch_simulator.py: float32 reduction
    # order, plus one quantizer step for a flipped stochastic-rounding code.
    if worst_loss > 1e-5 or worst_param > 5e-4:
        raise SystemExit("the card's run disagrees with the CPU reference")

    record = {"kernels": [{
        "name": "quantize",
        "route": "cuda",
        "source": "src/repro_torch/kernels/quantize/csrc/quantize.cu",
        "replaces": "src/repro/kernels/quantize/kernel.py:17",
        "launches": launches["quantize"],
        "max_abs_err": max_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
    }]}
    print(json.dumps(record))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
