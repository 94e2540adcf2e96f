#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

  python3 chip_smoke.py

Phases (each prints its own lines; any failure exits non-zero):
  1. device: the card's name and power limit (nvidia-smi), torch and CUDA
     versions;
  2. build: every CUDA kernel of the port, compiled with nvcc from the
     sources in this checkout (one nvcc a source, all started together),
     timed, with their registers and spills;
  3. kernels: each kernel against its plain PyTorch version on the card,
     on several cases and at its main path's shapes (quantize: exact
     equality; flash attention: atol 2e-6 in float32, 2e-2 in bf16), then
     its time per launch beside the plain version's time, the card's
     bound for the same work and, where one PyTorch call computes the same
     function, that call's time;
  4. FL main path: the registered `mnist_paper` experiment with int8 uplink
     compression (the paper's MNIST CNN, M=10 clients), built on the card
     and run for 6 rounds in two chunks; the quantize kernel must have
     launched on it once per round, losses must be finite and the uplink
     bits exact; then 36 more rounds timed in steady state (12 chunks of 3,
     no eval) and 3 under torch.profiler (device busy share, kernels by
     device time);
  5. FL reference: `mnist_smoke` with compression on the card and on the
     CPU (the CPU run takes the kernels' plain versions) from the same
     model and the same quantizer noise; the runs must agree;
  6. serve path: `qwen2-0.5b` at full width and depth (random weights from
     a seed), B=4 prompts of 2048 tokens, 32 generated tokens, through
     `serve.generate`; the flash kernel must launch once a layer in the
     prefill (24) and never in decode, logits must be finite, and the
     prefill's logits must agree with impl="plain" on the same weights;
     prefill and decode tokens/s, the flash kernel's share of prefill
     device time and the decode loop's device-busy share (torch.profiler);
  7. serve reference: the `qwen2-0.5b` smoke config on the card and on the
     CPU from the same weights and prompts, in float32 and in bf16; the
     runs must agree.

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
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

# The H100 SXM's published device-memory rate, float32 (non-tensor-core)
# peak and dense bf16 tensor-core peak, for the bound of a kernel's work.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
BF16_OPS_PER_S = 989e12

# The serve path's shape: qwen2-0.5b, 4 prompts of 2048 tokens, 32 tokens
# generated for each.
SERVE_BATCH, SERVE_PROMPT, SERVE_GEN = 4, 2048, 32


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


def profiled(fn):
    """Run fn() under torch.profiler: (its result, wall s, device-busy s,
    [(kernel, device s)] by device time). Only device-side events count (a
    CPU op's device time repeats its kernels')."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
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
    return out, wall, sum(by_name.values()), top


def bound(n_bytes, n_ops, ops_per_s):
    """(bound ms, "bytes" or "operations")."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / ops_per_s
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def phase_build(kernels):
    """Build every kernel, one nvcc a source, all started together."""
    def timed(ops):
        t0 = time.perf_counter()
        _, log = ops.load_kernel()
        return time.perf_counter() - t0, log

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(kernels)) as ex:
        futs = {name: ex.submit(timed, ops) for name, ops in kernels.items()}
        built = {name: f.result() for name, f in futs.items()}
    print(f"[build] {len(kernels)} kernels built in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    for name, (sec, log) in built.items():
        print(f"[build] {Path(kernels[name].SOURCE).name}: {sec:.2f} s")
        for line in log.splitlines():
            if ("registers" in line or "spill" in line or "error" in line
                    or "Compiling entry" in line):
                print(f"[build]   {line.strip()[:150]}")


# -- quantize ----------------------------------------------------------------


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


def phase_quantize_kernel(dev, card):
    import torch
    from repro_torch.kernels.quantize import ops, ref
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
    bound_ms, bound_by = bound(n_bytes, n_ops, FP32_OPS_PER_S)
    print(f"[kernel] quantize {R}x{D} on {card}: kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}: "
          f"{n_bytes / 1e6:.1f} MB), {bound_ms / ms:.1%} of bound",
          flush=True)
    return {"name": "quantize", "route": "cuda",
            "source": "src/repro_torch/kernels/quantize/csrc/quantize.cu",
            "replaces": "src/repro/kernels/quantize/kernel.py:17",
            "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}


# -- flash attention -----------------------------------------------------------

# name: (B, Sq, Sk, H, KV, hd, dtype, causal, window, q_offset)
FLASH_CASES = {
    "s64_f32": (2, 64, 64, 14, 2, 64, "float32", True, None, 0),
    "s200_bf16": (2, 200, 200, 14, 2, 64, "bfloat16", True, None, 0),
    "s384_f32": (1, 384, 384, 14, 2, 64, "float32", True, None, 0),
    "s384_bf16": (1, 384, 384, 14, 2, 64, "bfloat16", True, None, 0),
    "s2048_f32": (1, 2048, 2048, 14, 2, 64, "float32", True, None, 0),
    "window32_bf16": (1, 384, 384, 4, 2, 64, "bfloat16", True, 32, 0),
    "window128_f32": (1, 384, 384, 4, 2, 64, "float32", True, 128, 0),
    "window128_bf16": (1, 2048, 2048, 14, 2, 64, "bfloat16", True, 128, 0),
    "hd32_f32": (2, 200, 200, 4, 2, 32, "float32", True, None, 0),
    "hd32_bf16": (2, 200, 200, 4, 2, 32, "bfloat16", True, None, 0),
    "hd128_f32": (2, 200, 200, 4, 2, 128, "float32", True, None, 0),
    "hd128_bf16": (2, 200, 200, 4, 2, 128, "bfloat16", True, None, 0),
    "q_offset_bf16": (2, 64, 200, 14, 2, 64, "bfloat16", True, None, 136),
    "q_offset_window_f32": (1, 64, 256, 4, 2, 64, "float32", True, 32, 100),
    "rows_without_keys_f32": (1, 64, 40, 2, 1, 64, "float32", True, 32, 20),
    # The serve path's shape: qwen2-0.5b's prefill attention.
    "qwen2_prefill_bf16": (SERVE_BATCH, SERVE_PROMPT, SERVE_PROMPT, 14, 2, 64,
                           "bfloat16", True, None, 0),
}
FLASH_ATOL = {"float32": 2e-6, "bfloat16": 2e-2}


def flash_inputs(name, dev):
    import torch
    B, Sq, Sk, H, KV, hd, dtype, *_ = FLASH_CASES[name]
    g = torch.Generator(device=dev).manual_seed(len(name))
    return [torch.randn(shape, generator=g, device=dev).to(
        getattr(torch, dtype))
        for shape in ((B, Sq, H, hd), (B, Sk, KV, hd), (B, Sk, KV, hd))]


def phase_flash_kernel(dev, card):
    import torch
    from repro_torch.kernels.flash_attention import ops, ref
    max_err = 0.0
    for name, (*_, dtype, causal, window, q_offset) in FLASH_CASES.items():
        q, k, v = flash_inputs(name, dev)
        out = ops.flash_attention(q, k, v, causal, window, q_offset)
        torch.cuda.synchronize()
        want = ref.flash_attention_ref(q, k, v, causal, window, q_offset)
        err = float((out.float() - want.float()).abs().max())
        max_err = max(max_err, err)
        print(f"[kernel] flash_attention {name} q{tuple(q.shape)} "
              f"kv{tuple(k.shape)} window={window} q_offset={q_offset}: max "
              f"abs err {err:.3g} (atol {FLASH_ATOL[dtype]:g})", flush=True)
        if not err <= FLASH_ATOL[dtype]:
            raise SystemExit(f"flash attention kernel disagrees on {name}")
    q, k, v = flash_inputs("qwen2_prefill_bf16", dev)
    ms = time_ms(lambda: ops.flash_attention(q, k, v))
    plain_ms = time_ms(lambda: ref.flash_attention_ref(q, k, v), calls=5)
    # The library call, timed as a yardstick only: (B, H, S, hd) operands
    # made beforehand, so only the call itself is timed.
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    library_ms = time_ms(lambda: sdpa(qt, kt, vt, is_causal=True,
                                      enable_gqa=True))
    B, S, H, hd = q.shape
    pairs = S * (S + 1) // 2  # causal (query, key) pairs of one head
    n_ops = 4 * hd * pairs * B * H  # QK^T and PV, 2 FLOPs a multiply-add
    n_bytes = 2 * (q.numel() + k.numel() + v.numel() + q.numel())
    bound_ms, bound_by = bound(n_bytes, n_ops, BF16_OPS_PER_S)
    print(f"[kernel] flash_attention {tuple(q.shape)} kv {tuple(k.shape)} "
          f"bf16 causal on {card}: kernel {ms:.4f} ms, plain {plain_ms:.4f} "
          f"ms, scaled_dot_product_attention {library_ms:.4f} ms, bound "
          f"{bound_ms:.4f} ms ({bound_by}; {n_ops:.3g} FLOPs at the bf16 "
          f"peak, {n_bytes / 1e6:.1f} MB), {bound_ms / ms:.1%} of bound",
          flush=True)
    return {"name": "flash_attention", "route": "cuda",
            "source": ("src/repro_torch/kernels/flash_attention/csrc/"
                       "flash_attention.cu"),
            "replaces": "src/repro/kernels/flash_attention/kernel.py:24",
            "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms}


# -- FL path -------------------------------------------------------------------


def phase_fl_main_path(counters):
    import torch
    from repro_torch.federated import compression, experiment
    from repro_torch.utils.tree import leaves
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
    for ops in counters.values():
        ops.launches = 0
    t0 = time.perf_counter()
    state, res = sim.run(state, max_rounds=6, eval_every=3)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = {name: ops.launches for name, ops in counters.items()}
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
    _, wall, busy, top = profiled(
        lambda: sim.run(state, max_rounds=3, eval_every=3))
    print(f"[slice] profiled 3 rounds: wall {wall:.4f} s, device busy "
          f"{busy:.4f} s ({busy / wall:.1%}; idle {1 - busy / wall:.1%}), "
          "profiler on", flush=True)
    for name, sec in top[:8]:
        print(f"[slice]   {sec / 3 * 1e3:9.3f} ms/round {sec / busy:6.1%}  "
              f"{name[:90]}")
    q_sec = sum(sec for name, sec in top if "quantize_rows" in name)
    print(f"[slice]   quantize kernel: {q_sec / 3 * 1e3:.3f} ms/round, "
          f"{q_sec / busy:.1%} of device time", flush=True)
    return launches


def phase_fl_reference():
    """mnist_smoke on the card and on the CPU, on a small input."""
    import torch
    from repro_torch.federated import experiment
    from repro_torch.kernels.quantize import ref
    from repro_torch.utils.tree import leaves
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


# -- serve path ------------------------------------------------------------------

# The kernel path keeps scores and probabilities in float32 where the plain
# path rounds them to bf16 (the reference's rounding points); through 24
# bf16 layers the prefill logits drift apart by about 2% of their largest
# magnitude. Gate at 5%.
SERVE_LOGIT_TOL = 0.05


def phase_serve(counters):
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.launch import serve
    from repro_torch.models import transformer as tfm
    from repro_torch.utils.tree import leaves
    fa = counters["flash_attention"]
    cfg = get_config("qwen2-0.5b")
    t0 = time.perf_counter()
    params = tfm.init_params(cfg, torch.Generator().manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in leaves(params))
    print(f"[serve] {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}"
          f", {cfg.attention.n_heads} heads / {cfg.attention.n_kv_heads} kv, "
          f"vocab {cfg.vocab_size}, {n_params:,} parameters (float32, "
          f"{cfg.dtype} compute), drawn in {time.perf_counter() - t0:.2f} s",
          flush=True)
    prompts = serve.make_prompts(cfg, SERVE_BATCH, SERVE_PROMPT, seed=0)
    serve.generate(cfg, params, prompts, 2)  # warm-up: cuBLAS, allocator

    for ops in counters.values():
        ops.launches = 0
    res = serve.generate(cfg, params, prompts, SERVE_GEN)
    launches = {name: ops.launches for name, ops in counters.items()}
    B, S = prompts.shape
    steps = SERVE_GEN - 1
    print(f"[serve] generate B={B} prompt={S} gen={SERVE_GEN}: prefill "
          f"{res.prefill_s:.4f} s ({B * S / res.prefill_s:.1f} tokens/s), "
          f"decode {steps} steps in {res.decode_s:.4f} s "
          f"({B * steps / res.decode_s:.2f} tokens/s, "
          f"{res.decode_s / steps * 1e3:.2f} ms a step), launches {launches}",
          flush=True)
    if tuple(res.tokens.shape) != (B, SERVE_GEN):
        raise SystemExit(f"generated {tuple(res.tokens.shape)} tokens")
    if not (int(res.tokens.min()) >= 0
            and int(res.tokens.max()) < cfg.vocab_size):
        raise SystemExit("generated token ids out of the vocabulary")
    for name, t in (("prefill", res.prefill_logits),
                    ("last decode", res.last_logits)):
        if not bool(torch.isfinite(t).all()):
            raise SystemExit(f"non-finite {name} logits")
    if launches["flash_attention"] != cfg.n_layers:
        raise SystemExit(f"expected {cfg.n_layers} flash launches in "
                         f"generate, got {launches['flash_attention']}")
    if launches["quantize"]:
        raise SystemExit("the quantize kernel launched on the serve path")

    # The prefill alone, profiled: one flash launch a layer. Then decode
    # steps from its cache, profiled: no flash launch.
    fa.launches = 0
    (logits, cache), wall, busy, top = profiled(lambda: tfm.prefill(
        cfg, params, prompts.cuda(), max_len=S + SERVE_GEN, impl="kernel"))
    prefill_launches = fa.launches
    flash_s = sum(sec for name, sec in top if "flash_fwd" in name)
    print(f"[serve] profiled prefill: wall {wall:.4f} s, device busy "
          f"{busy:.4f} s ({busy / wall:.1%}), flash kernel {flash_s * 1e3:.3f}"
          f" ms = {flash_s / busy:.1%} of device time over "
          f"{prefill_launches} launches, profiler on", flush=True)
    for name, sec in top[:8]:
        print(f"[serve]   {sec * 1e3:9.3f} ms {sec / busy:6.1%}  {name[:90]}")
    if prefill_launches != cfg.n_layers:
        raise SystemExit(f"expected {cfg.n_layers} flash launches a prefill, "
                         f"got {prefill_launches}")
    tok = logits[:, -1].argmax(dim=-1).reshape(B, 1)
    fa.launches = 0
    n_steps = min(8, SERVE_GEN - 1)  # within the cache's max_len

    def decode_steps(tok=tok):
        for _ in range(n_steps):
            out, _ = tfm.decode_step(cfg, params, cache, tok)
            tok = out[:, 0].argmax(dim=-1).reshape(B, 1)
        return tok

    _, wall, busy, top = profiled(decode_steps)
    print(f"[serve] profiled {n_steps} decode steps: wall {wall:.4f} s, "
          f"device busy {busy:.4f} s ({busy / wall:.1%}; idle "
          f"{1 - busy / wall:.1%}), flash launches {fa.launches}, profiler "
          "on", flush=True)
    for name, sec in top[:5]:
        print(f"[serve]   {sec / n_steps * 1e3:9.3f} ms/step "
              f"{sec / busy:6.1%}  {name[:90]}")
    if fa.launches:
        raise SystemExit(f"decode launched the flash kernel {fa.launches} "
                         "times")

    # The kernel path against the plain path, same weights and prompts.
    plain = serve.generate(cfg, params, prompts, 1, impl="plain")
    gap = float((res.prefill_logits - plain.prefill_logits).abs().max())
    scale = float(plain.prefill_logits.abs().max())
    rel_l2 = float((res.prefill_logits - plain.prefill_logits).norm()
                   / plain.prefill_logits.norm())
    same_first = int((res.tokens[:, 0] == plain.tokens[:, 0]).sum())
    print(f"[serve] prefill logits kernel vs plain: max abs gap {gap:.4g} "
          f"of max |logit| {scale:.4g} ({gap / scale:.2%}; tol "
          f"{SERVE_LOGIT_TOL:.0%}), relative L2 {rel_l2:.3g}, first token "
          f"equal in {same_first}/{B} rows; plain prefill "
          f"{plain.prefill_s:.4f} s", flush=True)
    if not gap <= SERVE_LOGIT_TOL * scale:
        raise SystemExit("kernel and plain prefill logits disagree")
    return launches


def phase_serve_reference():
    """qwen2-0.5b's smoke config on the card and on the CPU (where the
    flash wrapper runs its plain version), same weights and prompts.
    Tolerances as tests/test_torch_transformer.py: float32 1e-5 of the
    logits' scale (1e-4 after decode, through the bf16 cache) with tokens
    identical; bf16 3e-2."""
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.launch import serve
    from repro_torch.models import transformer as tfm
    from repro_torch.utils.tree import tree_map
    for dtype, tol_first, tol_last in (("float32", 1e-5, 1e-4),
                                       ("bfloat16", 3e-2, 3e-2)):
        cfg = get_config("qwen2-0.5b", smoke=True).replace(dtype=dtype)
        cpu = tfm.init_params(cfg, torch.Generator().manual_seed(3),
                              device="cpu")
        gpu = tree_map(lambda t: t.cuda(), cpu)
        prompts = serve.make_prompts(cfg, 3, 150, seed=4)
        out = {"cuda": serve.generate(cfg, gpu, prompts, 4),
               "cpu": serve.generate(cfg, cpu, prompts, 4, device="cpu")}
        gaps = []
        for field, tol in (("prefill_logits", tol_first),
                           ("last_logits", tol_last)):
            a = getattr(out["cuda"], field).cpu()
            b = getattr(out["cpu"], field)
            scale = max(1.0, float(b.abs().max()))
            gaps.append(float((a - b).abs().max()) / scale)
            if not gaps[-1] <= tol:
                raise SystemExit(f"serve {dtype} {field}: card and CPU "
                                 f"differ by {gaps[-1]:.3g} of scale")
        same = bool(torch.equal(out["cuda"].tokens.cpu(), out["cpu"].tokens))
        print(f"[reference] qwen2-0.5b smoke {dtype} cuda vs cpu: prefill "
              f"logit gap {gaps[0]:.3g}, last logit gap {gaps[1]:.3g} of "
              f"scale, tokens identical: {same}", flush=True)
        if dtype == "float32" and not same:
            raise SystemExit("float32 greedy tokens differ, card vs CPU")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false: this script "
              "needs an NVIDIA card", file=sys.stderr)
        return 1
    from repro_torch.device import resolve_device
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.quantize import ops as q_ops
    counters = {"quantize": q_ops, "flash_attention": fa_ops}

    # -- 1. device ---------------------------------------------------------
    card = card_line()
    dev = resolve_device("cuda")
    print(f"[device] {card} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | {torch.cuda.get_device_name(0)} | "
          f"count {torch.cuda.device_count()} | tf32 matmul "
          f"{torch.backends.cuda.matmul.allow_tf32} cudnn "
          f"{torch.backends.cudnn.allow_tf32} | bf16 reduced-precision "
          "reduction "
          f"{torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction}",
          flush=True)

    # -- 2. build ------------------------------------------------------------
    phase_build(counters)

    # -- 3. kernels against their plain versions -----------------------------
    records = {"quantize": phase_quantize_kernel(dev, card),
               "flash_attention": phase_flash_kernel(dev, card)}

    # -- 4, 5. the FL path and its reference ---------------------------------
    fl_launches = phase_fl_main_path(counters)
    if fl_launches["flash_attention"]:
        raise SystemExit("the flash kernel launched on the FL path")
    phase_fl_reference()

    # -- 6, 7. the serve path and its reference ------------------------------
    serve_launches = phase_serve(counters)
    phase_serve_reference()

    records["quantize"]["launches"] = fl_launches["quantize"]
    records["flash_attention"]["launches"] = serve_launches["flash_attention"]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in keys}
                                  for r in records.values()]}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
