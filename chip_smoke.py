#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

  python3 chip_smoke.py

Phases (each prints its own lines; any failure exits non-zero):
  1. device: the card's name and power limit (nvidia-smi), torch and CUDA
     versions;
  2. build: every CUDA kernel of the port, compiled with nvcc from the
     sources in this checkout (one nvcc a source, all started together),
     timed, with their registers and spills, and fails if an instance of
     the scan kernel (selective_scan_fwd<N>) spills; then `cuobjdump -sass`
     of the flash library counts the wgmma (HGMMA) and TMA-load (UTMALDG)
     instructions of each bf16 instance (flash_fwd_sm90<hd>), and fails if
     either count is 0;
  3. kernels: each kernel against its plain PyTorch version on the card,
     on several cases and at its main paths' shapes (quantize: exact
     equality, timed at the FL shapes of phases 4, 10 and 11; flash
     attention: atol 2e-6 in float32 (the CUDA-core kernel), 2e-2 in bf16
     (the wgmma + TMA kernel);
     selective scan: 3e-5 of max(1, max |plain|)), then its time per launch
     beside the plain version's time, the card's bound for the same work
     and, where one PyTorch call computes the same function, that call's
     time; the scan also prints its resident warps an SM at the falcon
     shape (at least 24, or the run fails) and its time for one prompt
     (B=1);
  4. FL main path: the registered `mnist_paper` experiment with int8 uplink
     compression (the paper's MNIST CNN, M=10 clients), built on the card
     and run for 6 rounds in two chunks; the quantize kernel must have
     launched on it once per round, and no other kernel; losses must be
     finite and the uplink bits exact; then 36 more rounds timed in steady
     state (12 chunks of 3, no eval) and 3 under torch.profiler (device
     busy share, kernels by device time);
  5. FL reference: `mnist_smoke` with compression on the card and on the
     CPU (the CPU run takes the kernels' plain versions) from the same
     model and the same quantizer noise; the runs must agree;
 10. FL at CIFAR width: the registered `cifar_paper` experiment with int8
     compression (the paper's CIFAR CNN, 2,156,490 parameters, M=10, its
     own plan), as phase 4: one quantize launch a round over 10 x 2,110
     rows, exact uplink bits, steady state and a profiled window;
 11. the fleet: `run_fleet(seeds=range(4))` of compressed `mnist_paper` for
     6 rounds must launch the quantize kernel once a round for all four
     members (not four times); each member's clock, bits and rounds must
     equal its run alone; its 6-round loss and params gaps are printed
     beside those of one seed run alone twice and from a one-ulp nudge of
     its initial model; each round of a member, from equal states, must
     hold the member contract against a round alone (losses within 1e-5
     relative, params within 5e-4), on two fleets of 4 seeds, with each
     round's largest params gap printed beside that of a member fed
     another member's noise; fleet s/round beside 4 x the s/round of one
     run, and a profiled fleet window; then
     `examples/quickstart_torch.py`'s main on the card through its fleet
     summary (uncompressed: no kernel launches);
  6. serve path: `qwen2-0.5b` at full width and depth (random weights from
     a seed), B=4 prompts of 2048 tokens, 32 generated tokens, through
     `serve.generate`; the flash kernel must launch once a layer in the
     prefill (24), never in decode, and no other kernel may launch; logits
     must be finite, and the prefill's logits must agree with impl="plain"
     on the same weights; prefill and decode tokens/s, the flash kernel's
     share of prefill device time and the decode loop's device-busy share
     (torch.profiler);
  7. serve reference: the `qwen2-0.5b` smoke config on the card and on the
     CPU from the same weights and prompts, in float32 and in bf16; the
     runs must agree;
  8. serve path: `falcon-mamba-7b` at full width and depth (7.0e9 random
     weights drawn on the card from a seed), the same shape and gates as
     phase 6 with the selective-scan kernel in the flash kernel's place
     (64 launches in the prefill, none in decode);
  9. serve reference: as phase 7, for the `falcon-mamba-7b` smoke config;
 12. edge scenarios and faults, 6 rounds each, every path with the
     quantize kernel once a round: (a) the registered `mnist_storm`
     (`hetero_storm`, its own plan) compressed, as phase 4, with its clock,
     bits and participant counts equal to a CPU run's, its s/round beside
     phase 4's and the kernel on rows of dropped clients (all zero); (b)
     compressed `mnist_paper` under `unreliable_edge` (deadline, 2
     retries, crash/rejoin) with a quorum of 9 that rejects rounds, whose
     params must be unchanged bit for bit; (c) a guarded run whose
     `max_update_norm` binds (each round's update within it, the unguarded
     round 1 far past it) and a run at lr 1e5 that diverges, recovered by
     `run(recovery=RecoveryPolicy(...))` with its audit trail printed; (d)
     a compressed 4-seed fleet under `dropout`: one launch a round over
     65,120 rows, members exact in clock, bits and participants against
     their runs alone, and phase 11's per-round member contract.

Phases 10, 11 and 12 run right after phase 5; quantize's `launches` in the
JSON line are those of phases 4, 10, 11 and 12 (a, b, c's guarded run and
d). The last lines are the
kernels' JSON record, the card's name and power limit, and
{"ok": true, "device": {...}}. The script exits non-zero
without a result when no CUDA card is available or the port's package
is missing.
"""
import dataclasses
import gc
import json
import math
import re
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

# The FL phases' steady state: this many chunks of 3 rounds, each timed.
STEADY_CHUNKS = 12

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
    return {name: log for name, (_, log) in built.items()}


def phase_scan_spills(log):
    """Every instance of the scan kernel (N = 8 and 16) must be in ptxas's
    report with 0 bytes of spill stores and loads."""
    from repro_torch.kernels.selective_scan import ops
    spills, n = {}, None
    for line in log.splitlines():
        if "Function properties for" in line:
            m = re.search(r"selective_scan_fwdILi(\d+)E", line)
            n = int(m.group(1)) if m else None
        elif n is not None and "spill stores" in line:
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
            spills[n] = int(m.group(1)) + int(m.group(2))
            n = None
    print(f"[build] selective_scan_fwd<N> spill bytes: {spills}", flush=True)
    if sorted(spills) != list(ops.STATE_SIZES) or any(spills.values()):
        raise SystemExit(f"the scan instances spill or are missing from "
                         f"ptxas's report: {spills}")


def phase_flash_sass():
    """The bf16 flash kernel's SASS: each instance (hd 32, 64, 128) must
    hold wgmma (HGMMA) and TMA load (UTMALDG) instructions."""
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import ops
    cuobjdump = Path(build.nvcc_path()).parent / "cuobjdump"
    res = subprocess.run(
        [str(cuobjdump), "-sass", str(build.library_path(ops.SOURCE))],
        capture_output=True, text=True, check=True, timeout=300)
    counts, hd = {}, None
    for line in res.stdout.splitlines():
        if "Function :" in line:
            m = re.search(r"flash_fwd_sm90ILi(\d+)E", line)
            hd = int(m.group(1)) if m else None
            if hd is not None:
                counts[hd] = [0, 0]
        elif hd is not None:
            counts[hd][0] += "HGMMA" in line
            counts[hd][1] += "UTMALDG" in line
    for hd, (n_mma, n_tma) in sorted(counts.items()):
        print(f"[build] flash_fwd_sm90<{hd}> (bf16) SASS: {n_mma} HGMMA, "
              f"{n_tma} UTMALDG", flush=True)
    if sorted(counts) != list(ops.HEAD_DIMS) or not all(
            n_mma and n_tma for n_mma, n_tma in counts.values()):
        raise SystemExit(f"the bf16 flash instances lack wgmma or TMA "
                         f"instructions: {counts}")


# -- quantize ----------------------------------------------------------------

QUANTIZE_SHAPES = {"slice_16280x1024": 16280, "cifar_21100x1024": 21100,
                   "fleet_65120x1024": 65120}


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
    # The FL paths' shapes, one launch a round: mnist_paper's 10 clients x
    # 1,628 rows of 1024, cifar_paper's 10 x 2,110, and a fleet of 4
    # mnist_paper runs, 4 x 10 x 1,628.
    for name, rows in QUANTIZE_SHAPES.items():
        cases[name] = torch.randn(rows, 1024, generator=g) * 1e-3
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
    timed = {}
    for name in QUANTIZE_SHAPES:
        x = cases[name]
        u = ref.stochastic_noise(torch.Generator(device=dev).manual_seed(1),
                                 x.shape)
        ms = time_ms(lambda: ops.quantize(x, u))
        plain_ms = time_ms(lambda: ref.quantize_ref(x, u))
        R, D = x.shape
        # x and u read once (float32), codes written once (int8), one scale
        # a row
        n_bytes = R * D * (4 + 4 + 1) + R * 4
        n_ops = 7 * R * D  # abs, max, divide, add, floor, two-sided clamp
        bound_ms, bound_by = bound(n_bytes, n_ops, FP32_OPS_PER_S)
        print(f"[kernel] quantize {R}x{D} on {card}: kernel {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}:"
              f" {n_bytes / 1e6:.1f} MB), {bound_ms / ms:.1%} of bound",
              flush=True)
        timed[name] = (ms, plain_ms, bound_ms, bound_by)
    ms, plain_ms, bound_ms, bound_by = timed["slice_16280x1024"]
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
    # The wgmma + TMA kernel's edges: ragged S (TMA zero-fills the rows past
    # S, the kernel masks them), Sq != Sk with q_offset and a window, rows
    # without keys, no causal mask, the other head dims at S=2048.
    "s77_bf16": (2, 77, 77, 14, 2, 64, "bfloat16", True, None, 0),
    "s1_bf16": (2, 1, 1, 14, 2, 64, "bfloat16", True, None, 0),
    "q_offset_window_bf16": (1, 100, 300, 4, 2, 64, "bfloat16", True, 64,
                             200),
    "rows_without_keys_bf16": (1, 64, 40, 2, 1, 64, "bfloat16", True, 32,
                               20),
    "not_causal_bf16": (1, 100, 130, 2, 1, 32, "bfloat16", False, 16, 0),
    "hd32_s2048_bf16": (1, 2048, 2048, 14, 2, 32, "bfloat16", True, None, 0),
    "hd128_s2048_bf16": (1, 2048, 2048, 14, 2, 128, "bfloat16", True, None,
                         0),
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


# -- selective scan --------------------------------------------------------------

# name: (B, S, D, N, chunk, h0). The reference's sweep
# (tests/test_kernels_scan.py), a ragged D, S=1, a nonzero h0, the serve
# path's shape (falcon-mamba-7b's prefill scan) and one prompt of it alone.
SCAN_CASES = {
    "sweep_1x64x128_n8": (1, 64, 128, 8, 32, False),
    "sweep_2x128x256_n16": (2, 128, 256, 16, 32, False),
    "sweep_1x96x512_n16": (1, 96, 512, 16, 32, False),
    "sweep_2x100x128_n8": (2, 100, 128, 8, 32, False),
    "ragged_d200_n16": (2, 77, 200, 16, 32, False),
    "s1_n8": (3, 1, 256, 8, 128, False),
    "h0_n16": (2, 150, 384, 16, 64, True),
    "h0_ragged_n8": (1, 45, 130, 8, 32, True),
    "falcon_prefill_n16": (SERVE_BATCH, SERVE_PROMPT, 8192, 16, 128, False),
    "falcon_prompt_1x2048x8192_n16": (1, SERVE_PROMPT, 8192, 16, 128, False),
}
# Resident warps an SM the scan must reach at the falcon shape (one thread a
# channel held 7.8).
SCAN_MIN_WARPS_PER_SM = 24
# The reference's own tolerance for its scans, scaled by max(1, max |plain|).
SCAN_ATOL = 3e-5
# The H100 SXM's special-function units: 16 results a clock an SM (exp2 is
# one of them), 132 SMs, 1.98 GHz boost clock.
SFU_PER_S = 16 * 132 * 1.98e9


def scan_inputs(name, dev):
    """x, dt, A, B, C, D and h0 (or None), distributed as the reference's
    test inputs (tests/test_kernels_scan.py)."""
    import torch
    B, S, D, N, _, with_h0 = SCAN_CASES[name]
    g = torch.Generator(device=dev).manual_seed(len(name))

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev)

    x = randn(B, S, D)
    dt = torch.nn.functional.softplus(randn(B, S, D)) * 0.2
    A = -torch.exp(randn(D, N) * 0.3)
    Bm, Cm = randn(B, S, N), randn(B, S, N)
    Dskip = torch.linspace(0.5, 1.5, D, device=dev)
    return x, dt, A, Bm, Cm, Dskip, (randn(B, D, N) * 0.5 if with_h0
                                     else None)


def phase_scan_kernel(dev, card):
    import torch
    from repro_torch.kernels.selective_scan import ops, ref
    max_err = 0.0
    for name, (B, S, D, N, chunk, _) in SCAN_CASES.items():
        *args, h0 = scan_inputs(name, dev)
        y, h = ops.selective_scan(*args, chunk=chunk, h0=h0)
        torch.cuda.synchronize()
        y_r, h_r = ref.selective_scan_ref(*args, chunk=chunk, h0=h0)
        errs = []
        for got, want in ((y, y_r), (h, h_r)):
            err = float((got - want).abs().max())
            scale = max(1.0, float(want.abs().max()))
            errs.append((err, scale))
            max_err = max(max_err, err)
        print(f"[kernel] selective_scan {name} B={B} S={S} D={D} N={N} "
              f"h0={h0 is not None}: max abs err y {errs[0][0]:.3g} (scale "
              f"{errs[0][1]:.3g}), h {errs[1][0]:.3g} (scale "
              f"{errs[1][1]:.3g}); atol {SCAN_ATOL:g} x scale", flush=True)
        if not all(err <= SCAN_ATOL * scale for err, scale in errs):
            raise SystemExit(f"selective scan kernel disagrees on {name}")
    *args, _ = scan_inputs("falcon_prefill_n16", dev)
    ms = time_ms(lambda: ops.selective_scan(*args))
    plain_ms = time_ms(lambda: ref.selective_scan_ref(*args), warmup=2,
                       calls=3, reps=5)
    x, _, A, Bm, *_ = args
    B, S, D = x.shape
    N = A.shape[1]
    # x, dt read and y written (float32), B and C read, A and D read, the
    # final h written.
    n_bytes = 4 * (3 * B * S * D + 2 * B * S * N + D * N + D + B * D * N)
    # Per state element: dt*A, dA*h, (dt*x)*B, the add, h*C and its sum;
    # per channel step: dt*x, D*x and its add. The exps are counted apart.
    n_ops = 6 * B * S * D * N + 3 * B * S * D
    n_exp = B * S * D * N
    bound_ms, bound_by = bound(n_bytes, n_ops, FP32_OPS_PER_S)
    sfu_ms = n_exp / SFU_PER_S * 1e3
    print(f"[kernel] selective_scan B={B} S={S} D={D} N={N} on {card}: "
          f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
          f"{bound_ms:.4f} ms ({bound_by}: {n_bytes:,} bytes at 3.35 TB/s; "
          f"{n_ops:.3g} FLOPs take {n_ops / FP32_OPS_PER_S * 1e3:.4f} ms at "
          f"the float32 peak), {bound_ms / ms:.1%} of bound; the {n_exp:.3g} "
          f"exps take {sfu_ms:.4f} ms on the special-function units",
          flush=True)
    blocks_per_sm, grid, warps = ops.occupancy(B, D, N)
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    resident = min(blocks_per_sm, grid / n_sm) * warps
    print(f"[kernel] selective_scan B={B} S={S} D={D} N={N}: {grid} blocks "
          f"of {warps} warps on {n_sm} SMs, {blocks_per_sm} blocks an SM at "
          f"most, {resident:.1f} resident warps an SM (gate "
          f">= {SCAN_MIN_WARPS_PER_SM})", flush=True)
    if resident < SCAN_MIN_WARPS_PER_SM:
        raise SystemExit(f"the scan holds {resident:.1f} warps an SM")
    *one, _ = scan_inputs("falcon_prompt_1x2048x8192_n16", dev)
    one_ms = time_ms(lambda: ops.selective_scan(*one))
    print(f"[kernel] selective_scan one prompt B=1 S={S} D={D} N={N} on "
          f"{card}: kernel {one_ms:.4f} ms (B={B}: {ms:.4f} ms)", flush=True)
    return {"name": "selective_scan", "route": "cuda",
            "source": ("src/repro_torch/kernels/selective_scan/csrc/"
                       "selective_scan.cu"),
            "replaces": "src/repro/kernels/selective_scan/kernel.py:24",
            "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}


# -- FL path -------------------------------------------------------------------


def compressed_spec(name):
    from repro_torch.federated import experiment
    spec = experiment.get(name)
    return spec.replace(fed=dataclasses.replace(spec.fed,
                                                compress_updates=True))


def phase_fl_main_path(counters, name="mnist_paper", tag="slice",
                       card=""):
    """The registered spec `name` with int8 compression on the card (tag:
    the lines' prefix); returns the launches of its 6 rounds, its steady
    s/round and its device busy share, and the run's history."""
    import torch
    from repro_torch.federated import compression
    from repro_torch.models import cnn
    from repro_torch.utils.tree import leaves
    spec = compressed_spec(name)
    plan = spec.resolve_plan()
    n_params = sum(math.prod(s) for layer in
                   cnn.param_shapes(spec.model_config()).values()
                   for s in layer.values())
    print(f"[{tag}] {name}: {spec.model} ({n_params:,} parameters), "
          f"M={spec.fed.n_devices}, {spec.n_train} {spec.dataset} samples"
          + (f", scenario {spec.scenario}" if spec.scenario else ""),
          flush=True)
    print(f"[{tag}] plan: b*={plan.b} theta*={plan.theta:.4f} V={plan.V} "
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
    launches = {k: ops.launches for k, ops in counters.items()}
    for r in res.history:
        print(f"[{tag}] round {r.round}: sim_time={r.sim_time:.6f}s "
              f"train_loss={r.train_loss:.6f} uplink_bits={r.uplink_bits:.0f}"
              + (f" test_acc={r.test_acc:.4f}" if r.test_acc is not None
                 else ""))
    print(f"[{tag}] {elapsed / len(res.history):.4f} s per round on {card} "
          f"({len(res.history)} rounds, first-chunk warm-up included), "
          f"{rows} rows per client update, launches {launches}", flush=True)
    if launches["quantize"] != len(res.history):
        raise SystemExit(f"expected one quantize launch per round, got "
                         f"{launches['quantize']} in {len(res.history)}")
    if not all(math.isfinite(r.train_loss) for r in res.history):
        raise SystemExit("non-finite train loss on the main path")
    # Every update that reached the server (all M without a scenario).
    for r in res.history:
        n = sim.fed.n_devices if r.n_participants is None else r.n_participants
        if r.uplink_bits != n * bits:
            raise SystemExit(f"round {r.round}: uplink bits {r.uplink_bits} "
                             f"differ from {n} x {bits}")
    if not all(bool(torch.isfinite(p).all()) for p in leaves(res.params)):
        raise SystemExit("non-finite parameters after the main path")
    # Steady state: more chunks of 3 rounds, each timed alone on the
    # host's clock (a chunk ends in its loss fetch, so the device is done),
    # with no test eval inside the timed spans.
    per_round = []
    for _ in range(STEADY_CHUNKS):
        t0 = time.perf_counter()
        state, _ = sim.run_chunk(state, 3)
        per_round.append((time.perf_counter() - t0) / 3)
    print(f"[{tag}] steady state on {card}: median "
          f"{statistics.median(per_round)!r} s per round, min "
          f"{min(per_round)!r}, max {max(per_round)!r} "
          f"({STEADY_CHUNKS} chunks of 3 rounds, no eval; host-bound, varies "
          "by machine)",
          flush=True)
    _, wall, busy, top = profiled(
        lambda: sim.run(state, max_rounds=3, eval_every=3))
    print(f"[{tag}] profiled 3 rounds on {card}: wall {wall:.4f} s, device "
          f"busy {busy:.4f} s ({busy / wall:.1%}; idle {1 - busy / wall:.1%}),"
          " profiler on", flush=True)
    for kname, sec in top[:8]:
        print(f"[{tag}]   {sec / 3 * 1e3:9.3f} ms/round {sec / busy:6.1%}  "
              f"{kname[:90]}")
    q_sec = sum(sec for kname, sec in top if "quantize_rows" in kname)
    print(f"[{tag}]   quantize kernel: {q_sec / 3 * 1e3:.3f} ms/round, "
          f"{q_sec / busy:.1%} of device time", flush=True)
    return {"launches": launches, "s_per_round": statistics.median(per_round),
            "busy": busy / wall, "history": res.history}


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


# The fleet's members and the bounds a member's round holds against a round
# of it alone from the same state (Simulator.run_fleet's member contract;
# tests/test_torch_simulator.py's LOSS_RTOL and PARAM_ATOL). The contract is
# read on two fleets of 4: the phase's fleet and CONTRACT_SEEDS.
FLEET_SEEDS, CONTRACT_SEEDS = range(4), range(4, 8)
FLEET_LOSS_RTOL, FLEET_PARAM_ATOL = 1e-5, 5e-4


def _gaps(a, b):
    """(clock, bits, participants and rounds equal, max relative
    train-loss gap, max param gap, bit-identical) of two SimResults."""
    from repro_torch.utils.tree import leaves
    exact = len(a.history) == len(b.history) and all(
        (x.round, x.sim_time, x.T_cm, x.T_cp, x.uplink_bits,
         x.n_participants, x.rejected)
        == (y.round, y.sim_time, y.T_cm, y.T_cp, y.uplink_bits,
            y.n_participants, y.rejected)
        for x, y in zip(a.history, b.history))
    loss = max(abs(x.train_loss - y.train_loss) / abs(y.train_loss)
               for x, y in zip(a.history, b.history))
    pa, pb = leaves(a.params), leaves(b.params)
    param = max(float((x - y).abs().max()) for x, y in zip(pa, pb))
    same = loss == 0 and all(bool((x == y).all()) for x, y in zip(pa, pb))
    return exact, loss, param, same


def _ulp_nudged(state, seed):
    """`state` with every weight times 1 - 2^-23, 1 or 1 + 2^-23 (drawn
    from a CPU generator at `seed`; every client row alike)."""
    import torch
    from repro_torch.utils.tree import tree_map
    gen = torch.Generator().manual_seed(seed)
    return dataclasses.replace(state, params_C=tree_map(
        lambda x: x * (1 + torch.randint(-1, 2, x.shape[1:], generator=gen)
                       .to(x.device, x.dtype) * 2.0 ** -23), state.params_C))


def _member_contract(sim, seeds, rounds):
    """Each round of a fleet of `seeds`, from equal states, against one
    round of each member alone; fails on a round that breaks the contract.
    Returns the largest loss gap, and per round the largest param gap of
    the members and that of the first member fed the second's noise."""
    states = [sim.init(s) for s in seeds]
    worst_loss, member, wrong_noise = 0.0, [], []
    for _ in range(rounds):
        step = sim.run_fleet(states=states, max_rounds=1)
        member.append(0.0)
        for st, res in zip(states, step.results):
            _, solo = sim.run(st, max_rounds=1)
            exact, loss, param, _ = _gaps(res, solo)
            worst_loss, member[-1] = max(worst_loss, loss), max(member[-1],
                                                                param)
            if not (exact and loss <= FLEET_LOSS_RTOL
                    and param <= FLEET_PARAM_ATOL):
                raise SystemExit(
                    f"fleet round {res.history[0].round} of seed {st.seed} "
                    f"breaks the member contract: exact {exact}, loss gap "
                    f"{loss:.3g}, param gap {param:.3g}")
        _, solo = sim.run(states[0], max_rounds=1)
        _, other = sim.run(dataclasses.replace(states[0], rng=states[1].rng),
                           max_rounds=1)
        wrong_noise.append(_gaps(other, solo)[2])
        states = step.states
    return worst_loss, member, wrong_noise


def phase_fl_fleet(counters):
    """run_fleet of compressed mnist_paper (4 seeds, 6 rounds): one quantize
    launch a round for the whole fleet, exact clocks and bits, each member's
    every round within the contract of a round alone from the same state
    (8 seeds); then fleet s/round beside 4 x solo s/round."""
    import torch
    spec = compressed_spec("mnist_paper")
    sim = spec.build()
    S = len(FLEET_SEEDS)
    for ops in counters.values():
        ops.launches = 0
    t0 = time.perf_counter()
    fleet = sim.run_fleet(seeds=FLEET_SEEDS, max_rounds=6, eval_every=3)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = {name: ops.launches for name, ops in counters.items()}
    rounds = len(fleet.results[0].history)
    print(f"[fleet] run_fleet(seeds=range({S})) of compressed mnist_paper: "
          f"{rounds} rounds in {elapsed:.4f} s (warm-up included), launches "
          f"{launches}, summary {fleet.summary()}", flush=True)
    if launches["quantize"] != rounds:
        raise SystemExit(f"expected one quantize launch a fleet round, got "
                         f"{launches['quantize']} in {rounds} rounds")
    # Whole histories: clocks, bits and rounds exact. The losses and params
    # are printed beside two runs alone of one seed and a run of it from a
    # one-ulp nudge of its initial model: the dynamics amplify a float32
    # ulp, and cuDNN's default algorithms do not repeat a run alone bit for
    # bit, so 6-round histories are not held to the round bounds.
    _, again = sim.run(sim.init(FLEET_SEEDS[0]), max_rounds=6, eval_every=3)
    _, nudged = sim.run(_ulp_nudged(sim.init(FLEET_SEEDS[0]), 1),
                        max_rounds=6, eval_every=3)
    for s, res in zip(FLEET_SEEDS, fleet.results):
        _, solo = sim.run(sim.init(s), max_rounds=6, eval_every=3)
        exact, loss, param, same = _gaps(res, solo)
        print(f"[fleet] member {s} vs its run alone, 6 rounds: clock/bits/"
              f"rounds exact {exact}, max rel loss gap {loss:.3g}, max param "
              f"gap {param:.3g}, bit-identical {same}", flush=True)
        if s == FLEET_SEEDS[0]:
            for what, other in (("run twice", again),
                                ("from a one-ulp nudge", nudged)):
                _, loss2, param2, same2 = _gaps(other, solo)
                print(f"[fleet] seed {s} alone, {what}, 6 rounds: max rel "
                      f"loss gap {loss2:.3g}, max param gap {param2:.3g}, "
                      f"bit-identical {same2}", flush=True)
        if not (exact and all(math.isfinite(r.train_loss)
                              for r in res.history)):
            raise SystemExit(f"fleet member {s}: clock, bits or rounds "
                             "differ from its run alone")
    # The member contract, round by round, on 8 seeds; beside each round's
    # largest member gap, what a member fed another member's noise reads.
    for seeds in (FLEET_SEEDS, CONTRACT_SEEDS):
        loss, member, wrong = _member_contract(sim, seeds, rounds)
        print(f"[fleet] member contract, seeds {list(seeds)}, {rounds} rounds "
              f"from equal states: max rel loss gap {loss:.3g} (tol "
              f"{FLEET_LOSS_RTOL:g}); largest param gap a round "
              f"{[float(f'{g:.3g}') for g in member]} (tol "
              f"{FLEET_PARAM_ATOL:g}; at most {max(member) / FLEET_PARAM_ATOL:.1%}"
              f" of it); seed {seeds[0]} fed seed {seeds[1]}'s noise "
              f"{[float(f'{g:.3g}') for g in wrong]}; clock, bits and rounds "
              "exact", flush=True)
    # Steady state, no eval: fleet chunks of 3 rounds, each timed alone on
    # the host's clock, beside as many chunks of one member run alone.
    timing = spec.replace(with_eval=False).build()
    states, fleet_s = fleet.states, []
    for _ in range(STEADY_CHUNKS):
        t0 = time.perf_counter()
        states = timing.run_fleet(states=states, max_rounds=3,
                                  eval_every=3).states
        fleet_s.append((time.perf_counter() - t0) / 3)
    state, solo_s = fleet.states[0], []
    for _ in range(STEADY_CHUNKS):
        t0 = time.perf_counter()
        state, _ = timing.run_chunk(state, 3)
        solo_s.append((time.perf_counter() - t0) / 3)
    f_med, s_med = statistics.median(fleet_s), statistics.median(solo_s)
    print(f"[fleet] steady state: fleet of {S} median {f_med!r} s per round "
          f"(min {min(fleet_s)!r}, max {max(fleet_s)!r}); one run alone "
          f"median {s_med!r} s per round (min {min(solo_s)!r}, max "
          f"{max(solo_s)!r}); {S} x alone {S * s_med!r} s; fleet / ({S} x "
          f"alone) {f_med / (S * s_med):.3f} ({STEADY_CHUNKS} chunks of 3 "
          "rounds each, no eval)", flush=True)
    _, wall, busy, top = profiled(lambda: timing.run_fleet(
        states=states, max_rounds=3, eval_every=3))
    print(f"[fleet] profiled 3 fleet rounds: wall {wall:.4f} s, device busy "
          f"{busy:.4f} s ({busy / wall:.1%}; idle {1 - busy / wall:.1%}), "
          "profiler on", flush=True)
    for kname, sec in top[:8]:
        print(f"[fleet]   {sec / 3 * 1e3:9.3f} ms/round {sec / busy:6.1%}  "
              f"{kname[:90]}")
    return launches


def phase_quickstart(counters):
    """examples/quickstart_torch.py's main on the card, through its fleet
    summary (uncompressed: no kernel of the port launches)."""
    import importlib.util
    path = Path(__file__).resolve().parent / "examples" / "quickstart_torch.py"
    spec = importlib.util.spec_from_file_location("quickstart_torch", path)
    quickstart = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(quickstart)
    for ops in counters.values():
        ops.launches = 0
    t0 = time.perf_counter()
    res, fleet = quickstart.main(device="cuda")
    launches = {name: ops.launches for name, ops in counters.items()}
    summary = fleet.summary()
    print(f"[quickstart] examples/quickstart_torch.py main(device='cuda') in "
          f"{time.perf_counter() - t0:.2f} s, launches {launches}", flush=True)
    if any(launches.values()):
        raise SystemExit(f"kernels launched on the uncompressed quickstart: "
                         f"{launches}")
    if not (len(res.history) == 5 and len(fleet) == 4
            and all(math.isfinite(v) for v in summary.values())):
        raise SystemExit(f"the quickstart twin did not finish: {summary}")


# -- edge scenarios and faults (phase 12) -----------------------------------------

# (b)'s quorum: unreliable_edge keeps 8 or 9 of mnist_paper's 10 clients in
# these 6 rounds, so 9 rejects some rounds and passes others.
QUORUM = 9
# (c): every client's update norm in mnist_paper's first rounds is 0.28 or
# more (3.4 or more in round 1), so this norm clips every client.
MAX_UPDATE_NORM = 0.2
# (c): the lr at which compressed mnist_paper diverges by round 2, and the
# recovery policy that brings it back.
DIVERGE_LR = 1e5
RECOVERY = dict(max_restarts=4, lr_backoff=1e-3, tighten_guard=0.5)


def _zeroed_clients(rows, clients, dropped, seed):
    """(rows, 1024) deltas of `clients` clients with those in `dropped` all
    zero: what a round with dropped or rejected clients quantizes."""
    import torch
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(rows, 1024, generator=g) * 1e-3
    per = rows // clients
    for c in dropped:
        x[c * per:(c + 1) * per] = 0.0
    return x


def phase_storm_quantize(dev, card):
    """The quantize kernel on phase 12's inputs: rows of dropped clients
    all zero, at mnist_storm's 16,280 rows and the fleet's 65,120; exact
    against its plain version, timed beside it."""
    import torch
    from repro_torch.kernels.quantize import ops, ref
    out = {}
    for rows, clients, dropped in ((16280, 10, (1, 4, 7)),
                                   (65120, 40, (0, 5, 13, 22, 23, 39))):
        x = _zeroed_clients(rows, clients, dropped, rows).to(dev)
        u = ref.stochastic_noise(torch.Generator(device=dev).manual_seed(2),
                                 x.shape)
        q, sc = ops.quantize(x, u)
        q_r, s_r = ref.quantize_ref(x, u)
        bad = int((q != q_r).sum()) + int((sc != s_r).sum())
        ms = time_ms(lambda: ops.quantize(x, u))
        plain_ms = time_ms(lambda: ref.quantize_ref(x, u))
        print(f"[storm] quantize {rows}x1024, {len(dropped)} of {clients} "
              f"clients' rows zero, on {card}: {bad} mismatches, kernel "
              f"{ms:.4f} ms, plain {plain_ms:.4f} ms", flush=True)
        if bad:
            raise SystemExit("quantize kernel disagrees on zeroed rows")
        out[rows] = (ms, plain_ms)
    return out


def _launched(counters, fn):
    """fn() with every count set to 0 before it: (its result, launches)."""
    for ops in counters.values():
        ops.launches = 0
    out = fn()
    return out, {name: ops.launches for name, ops in counters.items()}


def _check_quantize_rounds(tag, launches, rounds):
    if launches["quantize"] != rounds:
        raise SystemExit(f"[{tag}] expected one quantize launch a round, "
                         f"got {launches['quantize']} in {rounds} rounds")


def phase_storm(counters, card, paper):
    """(a): compressed mnist_storm as phase 4, then the same spec on the
    CPU: clock, bits and participant counts equal, round for round."""
    storm = phase_fl_main_path(counters, "mnist_storm", "storm", card)
    cpu = compressed_spec("mnist_storm").build(device="cpu")
    _, res = cpu.run(cpu.init(), max_rounds=6, eval_every=3)
    key = lambda r: (r.round, r.sim_time, r.T_cm, r.T_cp,  # noqa: E731
                     r.uplink_bits, r.n_participants)
    same = [key(a) == key(b) for a, b in zip(storm["history"], res.history)]
    print(f"[storm] participants a round {[r.n_participants for r in res.history]}"
          f" of 10; clock, bits and participants equal to a CPU run's in "
          f"{sum(same)}/{len(same)} rounds", flush=True)
    if not (all(same) and len(same) == 6):
        raise SystemExit("mnist_storm's clock, bits or participants differ "
                         "from the CPU run's")
    print(f"[storm] on {card}: mnist_storm {storm['s_per_round']!r} s per "
          f"round ({storm['busy']:.1%} busy) beside mnist_paper "
          f"{paper['s_per_round']!r} s per round ({paper['busy']:.1%} busy),"
          " steady state, no eval", flush=True)
    return storm["launches"]


def phase_quorum(counters, card):
    """(b): compressed mnist_paper under unreliable_edge with a quorum that
    rejects; a rejected round leaves the params bit for bit."""
    import torch
    from repro_torch.federated import scenarios
    from repro_torch.utils.tree import leaves
    faults = scenarios.get("unreliable_edge").faults.replace(
        min_quorum=QUORUM, quorum_policy="reject")
    spec = compressed_spec("mnist_paper").replace(scenario="unreliable_edge",
                                                  faults=faults)
    sim = spec.build()

    def rounds():
        state, hist, unchanged = sim.init(), [], []
        for _ in range(6):
            before = state
            state, res = sim.run(state, max_rounds=1)
            rec = res.history[0]
            hist.append(rec)
            if rec.rejected:
                unchanged.append(all(torch.equal(a, b) for a, b in zip(
                    leaves(state.params_C), leaves(before.params_C))))
        return hist, unchanged

    (hist, unchanged), launches = _launched(counters, rounds)
    for r in hist:
        print(f"[quorum] round {r.round}: sim_time={r.sim_time:.6f}s "
              f"participants={r.n_participants} rejected={r.rejected} "
              f"uplink_bits={r.uplink_bits:.0f} train_loss={r.train_loss:.6f}",
              flush=True)
    print(f"[quorum] unreliable_edge + quorum {QUORUM} on {card}: deadline "
          f"{sim._deadline:.6f} s, b={sim.fed.batch_size} "
          f"V={sim.fed.local_rounds}, {len(unchanged)} rounds rejected, "
          f"params unchanged on them: {unchanged}, launches {launches}",
          flush=True)
    _check_quantize_rounds("quorum", launches, 6)
    if not unchanged or not all(unchanged):
        raise SystemExit("no rejected round, or a rejected round moved "
                         "the params")
    if not all(math.isfinite(r.train_loss) for r in hist):
        raise SystemExit("non-finite loss under unreliable_edge")
    return launches


def _moved(a, b):
    """L2 distance between the global models of two states."""
    import torch
    from repro_torch.utils.tree import leaves
    return float(torch.sqrt(sum(torch.sum((x[0] - y[0]).double() ** 2)
                                for x, y in zip(leaves(a.params_C),
                                                leaves(b.params_C)))))


def phase_guard(counters, card):
    """(c): a guarded run whose max_update_norm binds, then a diverging
    run recovered by run(recovery=...)."""
    from repro_torch.federated.faults import (DivergenceError, FaultModel,
                                              RecoveryPolicy)
    base = compressed_spec("mnist_paper")
    plain = base.replace(with_eval=False).build()
    s0 = plain.init()
    s1, _ = plain.run(s0, max_rounds=1)
    free = _moved(s1, s0)
    sim = base.replace(faults=FaultModel(max_update_norm=MAX_UPDATE_NORM),
                       with_eval=False).build()

    def guarded():
        state, moved, hist = sim.init(), [], []
        for _ in range(6):
            nxt, res = sim.run(state, max_rounds=1)
            moved.append(_moved(nxt, state))
            hist.extend(res.history)
            state = nxt
        return moved, hist

    (moved, hist), launches = _launched(counters, guarded)
    print(f"[guard] max_update_norm {MAX_UPDATE_NORM} on {card}: the global "
          f"model moved {[float(f'{m:.4g}') for m in moved]} a round (round 1"
          f" unguarded: {free:.4g}); losses "
          f"{[float(f'{r.train_loss:.5g}') for r in hist]}; launches "
          f"{launches}", flush=True)
    _check_quantize_rounds("guard", launches, 6)
    # Each client's delta is clipped to the norm; their weighted mean is
    # within it, and the int8 round trip adds its rounding on top.
    if not (free > 5 * MAX_UPDATE_NORM
            and max(moved) < 1.5 * MAX_UPDATE_NORM
            and all(math.isfinite(r.train_loss) for r in hist)):
        raise SystemExit("the update guard did not bind")

    poisoned = base.replace(
        fed=dataclasses.replace(base.fed, lr=DIVERGE_LR),
        faults=FaultModel(max_update_norm=1e9, reject_nonfinite=False))
    bad = poisoned.build()
    try:
        bad.run(bad.init(), max_rounds=6, eval_every=3)
        raise SystemExit(f"lr {DIVERGE_LR:g} did not diverge")
    except DivergenceError as e:
        print(f"[guard] lr {DIVERGE_LR:g}: DivergenceError at round {e.round}"
              f", last-good state at round {e.state.round}, finite clients "
              f"{e.finite_mask.tolist()}", flush=True)
    (state, res), rec_launches = _launched(counters, lambda: bad.run(
        bad.init(), max_rounds=6, eval_every=3,
        recovery=RecoveryPolicy(**RECOVERY)))
    for a in res.restarts:
        print(f"[guard] restart {a['attempt']}: diverged at round "
              f"{a['round']}, resumed from round {a['resume_round']}, "
              f"lr_scale {a['lr_scale']:g}, max_update_norm "
              f"{a['max_update_norm']:g}", flush=True)
    print(f"[guard] recovered run on {card}: rounds "
          f"{[r.round for r in res.history]}, losses "
          f"{[float(f'{r.train_loss:.5g}') for r in res.history]}, launches "
          f"{rec_launches} (restarted rounds included)", flush=True)
    if not (res.restarts and [r.round for r in res.history]
            == list(range(1, 7))
            and all(math.isfinite(r.train_loss) for r in res.history)):
        raise SystemExit("the recovery policy did not recover the run")
    return launches


def phase_dropout_fleet(counters, card):
    """(d): a compressed 4-seed fleet under dropout: one launch a round for
    all four, members exact in clock, bits and participants against their
    runs alone, and the per-round member contract of phase 11."""
    import torch
    spec = compressed_spec("mnist_paper").replace(scenario="dropout")
    sim = spec.build()
    S = len(FLEET_SEEDS)
    t0 = time.perf_counter()
    fleet, launches = _launched(counters, lambda: sim.run_fleet(
        seeds=FLEET_SEEDS, max_rounds=6, eval_every=3))
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    rounds = len(fleet.results[0].history)
    print(f"[dropout-fleet] run_fleet(seeds=range({S})) of compressed "
          f"mnist_paper under dropout on {card}: {rounds} rounds in "
          f"{elapsed:.4f} s (warm-up included), launches {launches}",
          flush=True)
    _check_quantize_rounds("dropout-fleet", launches, 6)
    for s, res in zip(FLEET_SEEDS, fleet.results):
        _, solo = sim.run(sim.init(s), max_rounds=6, eval_every=3)
        exact, loss, param, _ = _gaps(res, solo)
        print(f"[dropout-fleet] member {s}: participants "
              f"{[r.n_participants for r in res.history]}, clock/bits/"
              f"participants exact {exact}, 6-round loss gap {loss:.3g}, "
              f"param gap {param:.3g}", flush=True)
        if not exact:
            raise SystemExit(f"dropout fleet member {s} differs from its "
                             "run alone in clock, bits or participants")
    loss, member, wrong = _member_contract(sim, FLEET_SEEDS, rounds)
    print(f"[dropout-fleet] member contract, {rounds} rounds from equal "
          f"states: max rel loss gap {loss:.3g} (tol {FLEET_LOSS_RTOL:g}); "
          f"largest param gap a round {[float(f'{g:.3g}') for g in member]} "
          f"(tol {FLEET_PARAM_ATOL:g}); seed {FLEET_SEEDS[0]} fed seed "
          f"{FLEET_SEEDS[1]}'s noise {[float(f'{g:.3g}') for g in wrong]}",
          flush=True)
    return launches


# -- serve paths -----------------------------------------------------------------

# arch: (the kernel its prefill runs, a substring of that kernel's symbol in
# the profiler, the device its weights are drawn on). qwen2-0.5b's 494M
# weights come from a CPU generator as `serve.main` draws them;
# falcon-mamba-7b's 7.0e9 from a CUDA generator on the card (a CPU draw of
# 28 GB takes minutes), one layer at a time into the stacked leaves.
SERVE_ARCHS = {
    "qwen2-0.5b": ("flash_attention", "flash_fwd", "cpu"),
    "falcon-mamba-7b": ("selective_scan", "selective_scan_fwd", "cuda"),
}

# Kernel vs plain prefill logits, as a share of the largest logit. qwen2:
# the kernel keeps the scores in float32 where the plain path rounds them
# to bf16 (the reference's rounding points; both round P to bf16); through
# 24 bf16 layers the logits drift apart by about 2%. falcon-mamba-7b: the
# two paths differ only in the scan's float32 sum order, but where its y
# lands on the other side of a bf16 rounding boundary the gate's input
# moves by a bf16 ulp, and that travels through 64 layers. Both gated at
# 5%.
SERVE_LOGIT_TOL = 0.05
# The same in float32, on prompts of 256 tokens: only the kernels' sum
# orders differ (a few float32 ulps a layer). 1e-4 of the largest logit,
# ten times the CPU tests' 1e-5 for 2 layers, for the 24 and 64 layers here.
SERVE_F32_PROMPT, SERVE_F32_LOGIT_TOL = 256, 1e-4


def phase_serve(counters, arch):
    """`arch` at full width and depth through serve.generate; returns the
    launches of every kernel in that generate."""
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.launch import serve
    from repro_torch.models import transformer as tfm
    from repro_torch.utils.tree import leaves
    kernel, symbol, gen_device = SERVE_ARCHS[arch]
    ops = counters[kernel]
    cfg = get_config(arch)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = tfm.init_params(
        cfg, torch.Generator(device=gen_device).manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in leaves(params))
    mixer = (f"{cfg.attention.n_heads} heads / {cfg.attention.n_kv_heads} kv"
             if cfg.mixer == "attention" else
             f"mamba1 d_inner {cfg.ssm.expand * cfg.d_model} d_state "
             f"{cfg.ssm.d_state}")
    print(f"[serve] {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}"
          f", {mixer}, vocab {cfg.vocab_size}, {n_params:,} parameters "
          f"(float32, {cfg.dtype} compute; param_count() "
          f"{cfg.param_count()[0]:,}), drawn on {gen_device} in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    prompts = serve.make_prompts(cfg, SERVE_BATCH, SERVE_PROMPT, seed=0)
    serve.generate(cfg, params, prompts, 2)  # warm-up: cuBLAS, allocator

    for c in counters.values():
        c.launches = 0
    res = serve.generate(cfg, params, prompts, SERVE_GEN)
    launches = {name: c.launches for name, c in counters.items()}
    B, S = prompts.shape
    steps = SERVE_GEN - 1
    print(f"[serve] {arch} generate B={B} prompt={S} gen={SERVE_GEN}: "
          f"prefill {res.prefill_s:.4f} s ({B * S / res.prefill_s:.1f} "
          f"tokens/s), decode {steps} steps in {res.decode_s:.4f} s "
          f"({B * steps / res.decode_s:.2f} tokens/s, "
          f"{res.decode_s / steps * 1e3:.2f} ms a step), launches {launches}"
          f", peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    if tuple(res.tokens.shape) != (B, SERVE_GEN):
        raise SystemExit(f"generated {tuple(res.tokens.shape)} tokens")
    if not (int(res.tokens.min()) >= 0
            and int(res.tokens.max()) < cfg.vocab_size):
        raise SystemExit("generated token ids out of the vocabulary")
    for name, t in (("prefill", res.prefill_logits),
                    ("last decode", res.last_logits)):
        if not bool(torch.isfinite(t).all()):
            raise SystemExit(f"non-finite {name} logits")
    if launches[kernel] != cfg.n_layers:
        raise SystemExit(f"expected {cfg.n_layers} {kernel} launches in "
                         f"generate, got {launches[kernel]}")
    others = {k: n for k, n in launches.items() if k != kernel and n}
    if others:
        raise SystemExit(f"other kernels launched on the {arch} path: "
                         f"{others}")

    # The prefill alone, profiled: one kernel launch a layer. Then decode
    # steps from its cache, profiled: no kernel launch.
    ops.launches = 0
    (logits, cache), wall, busy, top = profiled(lambda: tfm.prefill(
        cfg, params, prompts.cuda(), max_len=S + SERVE_GEN, impl="kernel"))
    prefill_launches = ops.launches
    kernel_s = sum(sec for name, sec in top if symbol in name)
    print(f"[serve] {arch} profiled prefill: wall {wall:.4f} s, device busy "
          f"{busy:.4f} s ({busy / wall:.1%}), {kernel} kernel "
          f"{kernel_s * 1e3:.3f} ms = {kernel_s / busy:.1%} of device time "
          f"over {prefill_launches} launches, profiler on", flush=True)
    for name, sec in top[:8]:
        print(f"[serve]   {sec * 1e3:9.3f} ms {sec / busy:6.1%}  {name[:90]}")
    if prefill_launches != cfg.n_layers:
        raise SystemExit(f"expected {cfg.n_layers} {kernel} launches a "
                         f"prefill, got {prefill_launches}")
    tok = logits[:, -1].argmax(dim=-1).reshape(B, 1)
    ops.launches = 0
    n_steps = min(8, SERVE_GEN - 1)  # within the cache's max_len

    def decode_steps(tok=tok):
        for _ in range(n_steps):
            out, _ = tfm.decode_step(cfg, params, cache, tok)
            tok = out[:, 0].argmax(dim=-1).reshape(B, 1)
        return tok

    _, wall, busy, top = profiled(decode_steps)
    print(f"[serve] {arch} profiled {n_steps} decode steps: wall {wall:.4f} "
          f"s, device busy {busy:.4f} s ({busy / wall:.1%}; idle "
          f"{1 - busy / wall:.1%}), {kernel} launches {ops.launches}, "
          "profiler on", flush=True)
    for name, sec in top[:5]:
        print(f"[serve]   {sec / n_steps * 1e3:9.3f} ms/step "
              f"{sec / busy:6.1%}  {name[:90]}")
    if ops.launches:
        raise SystemExit(f"decode launched the {kernel} kernel "
                         f"{ops.launches} times")
    del logits, cache

    # The kernel path against the plain path, same weights and prompts.
    plain = serve.generate(cfg, params, prompts, 1, impl="plain")
    gap = float((res.prefill_logits - plain.prefill_logits).abs().max())
    scale = float(plain.prefill_logits.abs().max())
    rel_l2 = float((res.prefill_logits - plain.prefill_logits).norm()
                   / plain.prefill_logits.norm())
    same_first = int((res.tokens[:, 0] == plain.tokens[:, 0]).sum())
    print(f"[serve] {arch} prefill logits kernel vs plain: max abs gap "
          f"{gap:.4g} of max |logit| {scale:.4g} ({gap / scale:.2%}; tol "
          f"{SERVE_LOGIT_TOL:.0%}), relative L2 {rel_l2:.3g}, first token "
          f"equal in {same_first}/{B} rows; plain prefill "
          f"{plain.prefill_s:.4f} s", flush=True)
    if not gap <= SERVE_LOGIT_TOL * scale:
        raise SystemExit("kernel and plain prefill logits disagree")

    # The same comparison in float32 (no bf16 rounding to amplify the sum
    # order's ulps), on shorter prompts.
    cfg32 = cfg.replace(dtype="float32")
    short = prompts[:, :SERVE_F32_PROMPT]
    got, want = (serve.generate(cfg32, params, short, 1, impl=impl)
                 for impl in ("kernel", "plain"))
    gap = float((got.prefill_logits - want.prefill_logits).abs().max())
    scale = float(want.prefill_logits.abs().max())
    print(f"[serve] {arch} float32 prefill logits kernel vs plain, prompt "
          f"{SERVE_F32_PROMPT}: max abs gap {gap:.4g} of max |logit| "
          f"{scale:.4g} ({gap / scale:.3g}; tol {SERVE_F32_LOGIT_TOL:g}), "
          f"first token equal in "
          f"{int((got.tokens == want.tokens).sum())}/{B} rows", flush=True)
    if not gap <= SERVE_F32_LOGIT_TOL * scale:
        raise SystemExit("kernel and plain float32 prefill logits disagree")
    return launches


# arch: float32 (prefill, last decode) logit tolerances, as the CPU tests
# (tests/test_torch_transformer.py, tests/test_torch_mamba.py) hold them:
# 1e-5 of scale, 1e-4 after qwen2's decode through its bf16 KV cache
# (falcon-mamba-7b's decode state is float32). bf16: 3e-2 for both.
SERVE_REF_F32_TOL = {"qwen2-0.5b": (1e-5, 1e-4),
                     "falcon-mamba-7b": (1e-5, 1e-5)}


def phase_serve_reference(arch):
    """`arch`'s smoke config on the card and on the CPU (where the kernels'
    wrappers run their plain versions), same weights and prompts, in
    float32 and in bf16; float32 greedy tokens identical."""
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.launch import serve
    from repro_torch.models import transformer as tfm
    from repro_torch.utils.tree import tree_map
    for dtype, (tol_first, tol_last) in (
            ("float32", SERVE_REF_F32_TOL[arch]), ("bfloat16", (3e-2, 3e-2))):
        cfg = get_config(arch, smoke=True).replace(dtype=dtype)
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
                raise SystemExit(f"serve {arch} {dtype} {field}: card and "
                                 f"CPU differ by {gaps[-1]:.3g} of scale")
        same = bool(torch.equal(out["cuda"].tokens.cpu(), out["cpu"].tokens))
        print(f"[reference] {arch} smoke {dtype} cuda vs cpu: prefill logit "
              f"gap {gaps[0]:.3g}, last logit gap {gaps[1]:.3g} of scale, "
              f"tokens identical: {same}", flush=True)
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
    from repro_torch.kernels.selective_scan import ops as ss_ops
    counters = {"quantize": q_ops, "flash_attention": fa_ops,
                "selective_scan": ss_ops}

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
    logs = phase_build(counters)
    phase_scan_spills(logs["selective_scan"])
    phase_flash_sass()

    # -- 3. kernels against their plain versions -----------------------------
    records = {"quantize": phase_quantize_kernel(dev, card),
               "flash_attention": phase_flash_kernel(dev, card),
               "selective_scan": phase_scan_kernel(dev, card)}

    # -- 4, 5. the FL path and its reference ---------------------------------
    paper = phase_fl_main_path(counters, card=card)
    fl_launches = [paper["launches"]]
    phase_fl_reference()

    # -- 10, 11. cifar_paper; the fleet and the quickstart twin --------------
    fl_launches.append(phase_fl_main_path(counters, "cifar_paper", "cifar",
                                          card)["launches"])
    fl_launches.append(phase_fl_fleet(counters))
    phase_quickstart(counters)

    # -- 12. edge scenarios, faults and resilience ---------------------------
    phase_storm_quantize(dev, card)
    fl_launches.append(phase_storm(counters, card, paper))
    fl_launches.append(phase_quorum(counters, card))
    fl_launches.append(phase_guard(counters, card))
    fl_launches.append(phase_dropout_fleet(counters, card))
    for launches in fl_launches:
        others = {k: n for k, n in launches.items() if k != "quantize" and n}
        if others:
            raise SystemExit(f"other kernels launched on the FL path: "
                             f"{others}")

    # -- 6, 7. qwen2-0.5b serving and its reference --------------------------
    qwen2_launches = phase_serve(counters, "qwen2-0.5b")
    phase_serve_reference("qwen2-0.5b")
    # Free qwen2's weights and caches before the 28 GB of falcon-mamba-7b.
    gc.collect()
    torch.cuda.empty_cache()

    # -- 8, 9. falcon-mamba-7b serving and its reference ---------------------
    falcon_launches = phase_serve(counters, "falcon-mamba-7b")
    gc.collect()
    torch.cuda.empty_cache()
    phase_serve_reference("falcon-mamba-7b")

    records["quantize"]["launches"] = sum(n["quantize"] for n in fl_launches)
    records["flash_attention"]["launches"] = qwen2_launches["flash_attention"]
    records["selective_scan"]["launches"] = falcon_launches["selective_scan"]
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
