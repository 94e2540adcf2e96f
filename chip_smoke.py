#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

  python3 chip_smoke.py

Phases (each prints its own lines; any failure exits non-zero):
  1. device: the card's name and power limit (nvidia-smi), torch and CUDA
     versions;
  2. build: every CUDA kernel of the port, compiled with nvcc from the
     sources in this checkout (one nvcc a source, all started together),
     timed, with their registers and spills, and fails if an instance of
     the scan kernel (selective_scan_fwd<N>) or of the fold matmul (each
     tile and panel instance of ops.INSTANCES and the row kernel, printed
     with its registers) spills or is missing; prints the spill bytes
     of every flash instance (both dtypes, each head_dim); then
     `cuobjdump -sass` of the flash library counts the wgmma (HGMMA) and
     TMA-load (UTMALDG) instructions of each bf16 instance
     (flash_fwd_sm90<hd>), and fails if either count is 0 or an instance
     of ops.HEAD_DIMS is missing;
  3. kernels: each kernel against its plain PyTorch version on the card,
     on several cases and at its main paths' shapes (quantize: exact
     equality, timed at the FL shapes of phases 4, 10, 11, 18 and 20 (a
     loop client's or an async event's 1,628 rows), 19 (a sampled
     round's 50 x 1,628) and 21 (a trace-driven round's 12 x 1,628), also
     on the device alone (torch.profiler); flash
     attention: atol 2e-6 in float32 (the CUDA-core kernel), 2e-2 in bf16
     (the wgmma + TMA kernel), at head_dims 32, 64, 80, 128 and 256 (at
     128 also qwen3-moe-30b-a3b's GQA group of 8 and moonshot's MHA of
     16), timed at the prefill shapes of qwen2-0.5b, gemma-7b, zamba2-2.7b's
     shared block, musicgen-large and qwen3-moe-30b-a3b;
     selective scan: 3e-5 of max(1, max |plain|); fold matmul: 1e-4 of
     max(1, max |plain|) against torch.matmul at the Fig. 2 MNIST Study
     group's product shapes and at compressed `mnist_paper`'s own (the
     `paper_*` cases, four of them at batch 1 as a loop client runs them,
     the `loop_*` cases, and as an async event runs them at its plan, the
     `async_*` cases, and three at a sampled round's 50 lanes, the
     `sampled_*` cases), the tiles and panel routes equal to the row route
     (the oracle) as int32, and its rows unmoved bit for bit by more rows
     and by zeros appended to K), then its time per launch beside the plain
     version's time, the card's bound for the same work and, where one
     PyTorch call computes the same function, that call's time; the fold
     matmul also prints its route and instance, the row route's time, each
     time also on the device alone (torch.profiler: without the host's
     launch cost, which CUDA events count on a short launch) and a bound of
     three terms (bytes, operations, and one output's chain of K fmas at 4
     cycles each and the SM's highest clock); the scan also prints its
     resident warps an SM at the falcon shape (at least 24, or the run
     fails) and its time for one prompt (B=1);
  4. FL main path: the registered `mnist_paper` experiment with int8 uplink
     compression (the paper's MNIST CNN, M=10 clients), built on the card
     and run for 6 rounds in two chunks; the quantize kernel must have
     launched on it once per round, the fold matmul (every product of the
     CNN's local steps, FedAvg and eval) at least once, and no other
     kernel (so on every FL path below; an uncompressed one launches the
     fold matmul alone); losses must be
     finite and the uplink bits exact; then 36 more rounds timed in steady
     state (12 chunks of 3, no eval) and 3 under torch.profiler (device
     busy share, kernels by device time, the fold matmul's ms a round);
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
     run, and a profiled fleet window (with the fold matmul's ms a round);
     then
     `examples/quickstart_torch.py`'s main on the card through its fleet
     summary (uncompressed: the fold matmul alone launches);
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
     their runs alone, and phase 11's per-round member contract;
 13. serve path: `gemma-7b` at full width and depth (8.5e9 random weights
     drawn on the card), the shape and gates of phase 6 with the flash
     kernel at head_dim 256 (28 launches in the prefill, none in decode);
 14. serve reference: as phase 7, for the `gemma-7b` smoke config and a
     variant of it at head_dim 256 (in bf16 the variant may flip a greedy
     token only where the CPU's logits of the two tokens are a near-tie:
     `near_tie_flips`);
 15. serve path: `zamba2-2.7b` at full width and depth (2.3e9 weights drawn
     on the card): 54 mamba2 layers (plain torch) and, after each of its 9
     groups of 6, the shared attention block, whose prefill runs the flash
     kernel at head_dim 80 (9 launches, none in decode); gates of phase 6;
 16. serve reference: as phase 14, for the `zamba2-2.7b` smoke config and
     a variant of it whose shared block has head_dim 80.

 17. the Study (examples/defl_vs_fedavg_torch.py's Fig. 2 comparison):
     (a) DEFL (its plan, b* capped at 32), FedAvg (b=10, V=20) and Rand
     ((16, 15) on MNIST, (64, 30) on CIFAR) under `uniform`, 2 seeds, at
     full width (the paper's MNIST and CIFAR CNNs, M=10, 1,500 samples),
     up to the twin's 12 rounds with its 90% early stop: one group each,
     padded into its (V, b) envelope; the twin's rows printed; every
     member's plan, rounds, sim_time, T_cm, T_cp, uplink bits and
     participants must equal its own run alone's (a target_acc stop may
     fall on another round only where the two evals straddle the
     target); (b) the MNIST arms compressed: one quantize launch a round
     for the whole group; each round of every member, from equal states,
     against the same round alone: records exact, losses and params
     within 1e-5 / 5e-4 for every member-round (bit identity printed),
     and a planted control (FedAvg's and Rand's first members with their
     envelope masks swapped) that must break the loss bound; the quantize
     kernel at the group's row count against its plain version and bound;
     (c) Study(bit_check=True) on the Fig. 2 MNIST group itself, which
     probes all three arms (each padded) before its 1 round; (d) each
     group's s/round beside the sum of its members' s/round alone, its
     padding share, peak memory and a profiled round with the fold
     matmul's share (none a gate).
 18. the per-round backends, compressed `mnist_paper` at full width from
     one seed: (a) `scan`, `batched` and `loop`, 3 rounds each: one
     quantize launch a round on `batched`, one a participating client on
     `loop` (10 a round), the fold matmul on both and no other kernel;
     `batched` equal to `scan` (and phase 4's first records) bit for bit;
     `loop` against `batched`: clock, bits and rounds exact, losses within
     1e-5 relative, params within 2e-3 (bit identity printed); `loop`'s
     `run_round` x3 equal to its `run`; (b) uncompressed, `loop` against
     `batched` within 1e-5 (the fold matmul alone launches); (c) per
     backend, 3 rounds, `save_state`, `load_state` into a fresh simulator
     and 3 more rounds, bit for bit against 6 rounds alone, and the card's
     checkpoint refused by a CPU simulator (the generator-kind
     ValueError); (d) steady-state s/round of `batched` and `loop` (6
     rounds each, no eval) beside phase 4's `scan`, and one profiled `loop`
     round (busy share, launches, the fold matmul's ms); none of (d) a
     gate.
 19. sampled participation, compressed `mnist_paper` at full width with
     its own plan, K-client cohorts drawn each round from M clients: (a)
     K = M = 10 on `scan` and `batched`, 3 rounds: one quantize launch a
     round, the records (every field but the participant count) equal to
     phase 4's first 3 and the params to a dense run's, bit for bit; (b)
     K = 50 of M = 10,000 (virtual data shards: M > n_train), 3 rounds:
     `batched` equal to `scan` bit for bit, one quantize launch a round
     over 50 x 1,628 rows, 50 lanes in every leaf of params_C, and the
     state's bytes those of a dense M = 50 build (the O(K) gate); (c)
     `CohortSpec(K=50, spare=10)` under `unreliable_edge`: 3 rounds,
     `save_state`, `load_state` into a fresh build and 3 more, bit for bit
     against 6 rounds alone, the kept cohorts equal to a host
     recomputation of the selection and the clients whose data advanced
     exactly the kept ones; (d) `run_fleet` of 4 seeds of (b): one launch
     a round over 4 x 50 x 1,628 rows, each member its run alone bit for
     bit; (e) compressed `mnist_sampled` 4 rounds on the card and on the
     CPU from the same model and noise: cohorts, clock, bits and
     participants exact, losses and params within phase 5's tolerances;
     (f) steady-state s/round of (b) beside a dense M = 50 run (printed
     against the reference's CPU gate of 0.9x, not a gate), the host's
     share of a round (cohort draw, the M-wide realization and uplink,
     the index stack) and one profiled round (busy share, the fold
     matmul's ms a round, launches); none of (f) a gate.
 20. the asynchronous backend (the event queue): (a) compressed
     `mnist_paper` at full width with `backend="async"`,
     `AsyncSpec(buffer_size=5, staleness="poly")` under `stragglers`:
     `run_events` for 11 events, then `run(max_rounds=6)`: one quantize
     launch an event over one client's 1,628 rows, the fold matmul, no
     other kernel; the host twin's pops equal the device's in every
     chunk, the event clock monotone, each record's uplink bits a host
     recomputation's, losses finite; (b) 7 events (mid-buffer),
     `save_state`, `load_state` into a fresh simulator, on to 4
     aggregations: bit for bit against 4 alone; (c) the sync limit:
     uncompressed `mnist_paper`, buffer_size=10, staleness "constant",
     `uniform`, 3 aggregations against 3 `scan` rounds within 1e-5 / 5e-4
     (the gap and bit identity printed); (d) compressed `mnist_async` on
     the card and on the CPU from the same model and noise: records
     exact, losses and params within phase 5's bounds; (e) `fedasync`
     (K=1, server_lr 0.5) runs and differs from `fedbuff` at K=1; (f) one
     chunk's events under `torch.cuda.set_sync_debug_mode("error")`: no
     host synchronisation inside; (g) steady-state s/event and
     s/aggregation of (a) beside `scan`'s s/round of the same spec, the
     host's draws an event (twin, dispatch draw, batch indices), a
     profiled window (busy share, kernels by device time, the fold
     matmul's and quantize's ms an event) and
     `examples/async_vs_sync_torch.py --quick --scenario stragglers`
     with its table; none of (g) a gate.
 21. trace-driven fleets and the online planner: (a) compressed
     `mnist_diurnal` (the `diurnal_edge` fleet of phones, tablets and IoT
     gateways with diurnal availability and battery and thermal gates,
     M = 12, its own plan) at the paper CNN's full width, 6 rounds in two
     chunks: one quantize launch a round over 12 x 1,628 rows, the fold
     matmul, no other kernel; participants, clock and uplink bits equal
     to a host recomputation from the trace stream's `draw_chunk` on the
     same population and seed; some round has fewer than 12
     participants; finite losses; (b) 3 rounds, `save_state`,
     `load_state` into a fresh simulator, 3 more: bit for bit against
     (a)'s 6 (the trace's battery, thermal and RNG state ride the
     snapshot); (c) `record_trace("diurnal_edge", 12, 8)` into a
     temporary directory, replayed through `ExperimentSpec(trace=
     TraceSpec(path))` at full width: 6 rounds whose participants are the
     recorded arrivals; a 2-arm Study on that spec (the DEFL plan and
     FedAvg at b = 10, V = 20) forms one group, each member against its
     run alone over 3 rounds (records exact, loss within 1e-5 relative,
     params within 5e-4); (d) compressed `mnist_diurnal` at its
     registered size on the card and on the CPU from the same model and
     noise: records exact, losses and params within phase 5's bounds; (e)
     `examples/planner_service_demo_torch.py --quick --check` with its
     table; (f) steady-state s/round of (a) beside phase 4's, the host's
     trace draws a chunk and a profiled window (busy share, kernels by
     device time, the fold matmul's and quantize's ms a round); none of
     (e)'s timing or (f) a gate.
 22. serve path: `musicgen-large` at full width and depth (3.26e9 random
     weights drawn on the card, 13.0 GB): B=4 prompts of 2048 x 4
     codebook tokens, 32 generated, tokens (4, 32, 4); the flash kernel at
     head_dim 64 (48 launches in the prefill, none in decode); the gates
     of phase 6;
 23. serve reference: as phase 7, for the `musicgen-large` smoke config,
     without and with a conditioning prefix (prefill(prefix_embeds=)); in
     bf16 a codebook token may flip card vs CPU only at a near-tie;
 24. training: (a) `launch/train.py` at `qwen2-0.5b`'s full width on the
     card (`--clients 2 --batch 8 --seq 128 --V 2 --rounds 2 --defl`: the
     plan's b* = 256 capped at 64 takes the batch's place), impl="kernel":
     the DEFL plan line equal to a host recomputation from the analytic
     parameter count, 24 x V x clients x rounds = 192 flash launches (the
     forward; the backward is the plain version's VJP), the fold matmul
     (FedAvg) and no other kernel, finite losses with round 1 within 2 of
     ln(vocab); s/round, and a third round profiled (busy share, device
     time by kernel); (c) the trained model's first attention layer at the
     training shape through the kernel against the plain path, gradients
     within 1e-5 of max |g| in float32 and 2e-2 in bf16, wq, wk, wv
     nonzero; the selective scan under grad raises and launches nothing;
     (d) the trained params through `checkpoint/io.py` and back, bit for
     bit; (b) the `qwen2-0.5b` smoke config through `train.run` and the
     `musicgen-large` smoke config (codebooks and a prefix) through its
     local steps, card vs CPU from equal weights and batches: losses and
     params within 1e-5 in float32, 3e-2 in bf16; (e) `train.py --arch
     qwen3-moe-30b-a3b --smoke`, one round: the plan line equal to its
     host recomputation, finite losses, one flash launch a layer and
     local step, the loss at the trained params = ce + the router's aux
     loss (> 0); its float32 config card vs CPU within 1e-5; (f)
     `falcon-mamba-7b`'s smoke config in float32: the loss's gradients
     through the scan kernel (its backward the plain version's VJP)
     within 1e-5 of the plain path's in every leaf, every mixer leaf
     nonzero, then `train.py --arch falcon-mamba-7b --smoke` takes a round
     (one scan launch a layer and local step);
 25. serve path: `qwen3-moe-30b-a3b` at its published widths (d_model
     2048, 32/4 heads of 128, 128 experts of 768, top 8, vocab 151,936)
     with its depth cut from 48 to 16 layers (1.06e10 float32 weights
     drawn on the card): the gates of phase 6 (16 flash launches a
     prefill, none in decode), and each prefill layer's capacity (640
     slots an expert) and dropped share and the router's smallest top-k
     margin;
 26. serve reference: as phase 7, for the smoke configs of
     qwen3-moe-30b-a3b, moonshot-v1-16b-a3b, llama4-scout-17b-a16e,
     qwen3-32b and llava-next-34b (also with a vision prefix); an MoE
     config prints its router's smallest top-k margin and its dropped
     shares, and in bf16 may flip a greedy token only at a near-tie;
 27. dry run (no kernel): (a) one pair of `python -m
     repro_torch.launch.dryrun` (qwen2-0.5b train_4k on the single mesh,
     on fake tensors) in a spawned worker, as the sweep runs each of its
     40 (the sweep is host work: the CPU tests and the README's command
     run it), started before phase 25 on an idle host core: ok, the
     worker did not initialise CUDA; its FedAvg plan and counted FLOPs
     over the analytic model's; then the multipod demo twin (gemma-7b
     train_4k on the 2x16x16 mesh), this process's CUDA allocation
     unchanged by it; (b)
     qwen2-0.5b decode_32k on a (1, 1) mesh: the dry run's argument bytes
     within 1% of the card's allocation for the same params, cache and
     tokens, and three decode steps (CUDA events) against max(counted
     FLOPs / PEAK_FLOPS, argument bytes / HBM_BW), the share of that bound
     at most 1.05; (c) each served arch's prefill time of phases 6, 8, 13,
     15, 22 and 25 (not run again) beside its model, counted and analytic
     FLOPs at that shape, model FLOPs / (prefill s x PEAK_FLOPS) at most
     1.05.
 28. `shard_clients` across ranks, uncompressed: (a) `mnist_paper` at full
     width in an NCCL group of one rank (a HashStore), 3 rounds: records
     and params bit-equal to the unsharded run's, the fold matmul alone
     launched; (b) two gloo ranks spawned on the one card, CUDA tensors
     through gloo: `mnist_paper` over 5 lanes each (3 rounds, then a
     2-seed fleet) and `mnist_sampled` at K = 50 of M = 10,000 (25 lanes
     a rank): records exact, losses within 1e-5 relative and params
     within 5e-4 of the unsharded runs', the two ranks bit-equal, the
     fold matmul launched on each rank (counted there) and nothing else;
     (c) 'int8_shardmap' across the two ranks: int8 codes on the wire,
     within one quantizer step of the largest client delta of
     'allreduce' at mnist_paper's width, within 2/127 on the reference
     test's round; (d) steady s/round of (a) and of a rank of (b) beside
     the unsharded round, and the all_reduce's ms a round in each (none
     of (d) a gate).

Phases 10, 11, 12, 18, 19, 20, 21, 17 and 28 run right after phase 5, in
that order, phases 13-16 after phase 9, then 22, 23, 24, 25, 26 and 27;
quantize's `launches` in the JSON line are those of phases 4, 10, 11, 12 (a, b, c's
guarded run and d), 17 (b), 18, 19, 20 and 21, the fold matmul's those of
the same FL paths, of the quickstart twin, 17 (a, c), 28 (a, and (b)'s
ranks, counted in each rank's process) and 24 (a)'s FedAvg,
flash attention's those of phases 6, 13, 15, 22, 24 (a, e), 25 and 26's
card runs (24 + 28 + 9 + 48 + 192 + 8 + 16 + 24), the selective scan's
those of phases 8 and 24 (f) (64 + 8). The last lines are the
kernels' JSON record, the card's name and power limit, and
{"ok": true, "device": {...}}. The script exits non-zero
without a result when no CUDA card is available or the port's package
is missing.
"""
import contextlib
import dataclasses
import gc
import json
import math
import pickle
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

# The kernels of the FL paths: every product of the CNN's local steps, of
# FedAvg and of eval is the fold matmul; a compressed round adds one
# quantize launch.
FL_KERNELS = ("quantize", "fold_matmul")

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


def device_ms(fn, calls=10):
    """Device time per call: torch.profiler's CUDA kernel time over `calls`
    calls after one warm-up, so the host's launch cost, which CUDA events
    around a few short launches would count, does not."""
    import torch
    fn()
    torch.cuda.synchronize()
    # The profiler now and then reports a window without its device events
    # (no device time at all); such a window is taken again.
    for _ in range(3):
        _, _, busy, _ = profiled(lambda: [fn() for _ in range(calls)])
        if busy > 0:
            return busy / calls * 1e3
    raise SystemExit("torch.profiler reported no device time in 3 windows")


def print_fold_time(tag, top, busy, rounds):
    """The fold matmul's kernels (every instance and the row kernel) in a
    profiled window: ms a round and share of the device time."""
    sec = sum(s for kname, s in top if "::fold_" in kname)
    print(f"[{tag}]   fold matmul kernels: {sec / rounds * 1e3:.3f} ms/round, "
          f"{sec / busy:.1%} of device time", flush=True)


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


def phase_fold_spills(log):
    """Every fold matmul instance (ops.INSTANCES and the row kernel) must be
    in ptxas's report with 0 bytes of spill stores and loads; prints each
    one's registers."""
    from repro_torch.kernels.fold_matmul import ops
    by_params = {v: k for k, v in ops.INSTANCES.items()}
    found, name = {}, None
    for line in log.splitlines():
        if "Function properties for" in line:
            m = re.search(r"fold_tileILi(\d+)ELi(\d+)ELi(\d+)ELi(\d+)"
                          r"ELi(\d+)ELi(\d+)E", line)
            name = (by_params.get(tuple(map(int, m.groups())), m.group(0))
                    if m else "rows" if "fold_matmul_rows_kernel" in line
                    else None)
        elif name is not None and "spill stores" in line:
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
            found[name] = [None, int(m.group(1)) + int(m.group(2))]
        elif name is not None and "registers" in line:
            found[name][0] = int(re.search(r"Used (\d+) registers",
                                           line).group(1))
            name = None
    print("[build] fold_matmul instances (registers, spill bytes): " + ", ".join(
        f"{k}: {tuple(v)}" for k, v in sorted(found.items())), flush=True)
    if set(found) != set(ops.INSTANCES) | {"rows"} or any(
            spill for _, spill in found.values()):
        raise SystemExit(f"fold matmul instances spill or are missing from "
                         f"ptxas's report: {found}")


def phase_flash_spills(log):
    """ptxas's spill bytes (stores + loads) of every flash instance, bf16
    (flash_fwd_sm90<hd>) and float32 (flash_fwd<float, hd>), each hd of
    ops.HEAD_DIMS; fails if one is missing from the report. A spill is
    printed, not failed: flash_fwd_sm90<256> spills (its 64 x 256 float32
    O accumulator is 128 registers a thread of ptxas's 168)."""
    from repro_torch.kernels.flash_attention import ops
    spills, name = {}, None
    for line in log.splitlines():
        if "Function properties for" in line:
            m = re.search(r"flash_fwd(_sm90)?I(f)?Li(\d+)E", line)
            name = None if m is None else (
                f"flash_fwd_sm90<{m.group(3)}>" if m.group(1)
                else f"flash_fwd<float, {m.group(3)}>")
        elif name is not None and "spill stores" in line:
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
            spills[name] = (int(m.group(1)), int(m.group(2)))
            name = None
    print("[build] flash spill bytes (stores, loads): " + ", ".join(
        f"{k}: {v}" for k, v in sorted(spills.items())), flush=True)
    want = {f"flash_fwd_sm90<{hd}>" for hd in ops.HEAD_DIMS} | {
        f"flash_fwd<float, {hd}>" for hd in ops.HEAD_DIMS}
    if set(spills) != want:
        raise SystemExit(f"flash instances missing from ptxas's report: "
                         f"{sorted(want - set(spills))}")


def phase_flash_sass():
    """The bf16 flash kernel's SASS: each instance (hd 32, 64, 80, 128,
    256) must hold wgmma (HGMMA) and TMA load (UTMALDG) instructions."""
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
                   "fleet_65120x1024": 65120, "loop_1628x1024": 1628,
                   "sampled_81400x1024": 81400,
                   "diurnal_19536x1024": 19536}


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
    # mnist_paper runs, 4 x 10 x 1,628; then one launch a participating
    # client on the loop backend (phase 18) and one an arrival event on the
    # async backend (phase 20): 1,628 rows; a sampled round's cohort of
    # 50 lanes (phase 19): 50 x 1,628; and a trace-driven round of
    # mnist_diurnal's 12 clients at full width (phase 21): 12 x 1,628.
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
        dev_ms = device_ms(lambda: ops.quantize(x, u))
        plain_ms = time_ms(lambda: ref.quantize_ref(x, u))
        R, D = x.shape
        # x and u read once (float32), codes written once (int8), one scale
        # a row
        n_bytes = R * D * (4 + 4 + 1) + R * 4
        n_ops = 7 * R * D  # abs, max, divide, add, floor, two-sided clamp
        bound_ms, bound_by = bound(n_bytes, n_ops, FP32_OPS_PER_S)
        print(f"[kernel] quantize {R}x{D} on {card}: kernel {ms:.4f} ms "
              f"({dev_ms:.4f} on the device), plain {plain_ms:.4f} ms, bound "
              f"{bound_ms:.4f} ms ({bound_by}: {n_bytes / 1e6:.1f} MB), "
              f"{bound_ms / ms:.1%} of bound ({bound_ms / dev_ms:.1%} on the "
              "device)", flush=True)
        timed[name] = (ms, plain_ms, bound_ms, bound_by)
    ms, plain_ms, bound_ms, bound_by = timed["slice_16280x1024"]
    return {"name": "quantize", "route": "cuda",
            "source": "src/repro_torch/kernels/quantize/csrc/quantize.cu",
            "replaces": "src/repro/kernels/quantize/kernel.py:17",
            "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}


# -- fold matmul ------------------------------------------------------------------

# name: (batch, M, K, N, layout) at the Fig. 2 MNIST Study group's shapes
# (phase 17: 6 members x 10 clients = 60 rows of the client axis, B_env 32):
# a conv's forward (patches @ filter), its weight gradient (patches^T @
# dz, K over samples x pixels), a bias gradient (a broadcast row of ones),
# fc1's forward, weight and input gradients, the FedAvg sum over 10
# clients of fc1's 1.6M weights (weights broadcast over 6 members), and a
# ragged case; then the main path's own: the 8 products of a compressed
# `mnist_paper` local step (phase 4: 10 clients, b* = 16) with K >= 512,
# four of them at batch 1, a client of the loop backend (phase 18), the
# same four at an async event's batch 1 (phase 20: under `stragglers` the
# plan gives b* = 8, so conv2 sees 8 x 196 positions), and three at a
# sampled round's 50 lanes (phase 19: M = 10,000, whose plan gives b* =
# 32, so conv2 sees 32 x 196 positions).
# layout: "nn" both row-major, "tn" A transposed, "nt" B transposed, "ones"
# A a broadcast row of ones, "wbc" A one row a batch entry, broadcast.
FOLD_CASES = {
    "ragged": (3, 70, 33, 65, "nn"),
    "conv2_fwd": (60, 6272, 800, 64, "nn"),
    "conv2_wgrad": (60, 800, 6272, 64, "tn"),
    "conv1_wgrad": (60, 25, 25088, 32, "tn"),
    "conv2_bias_grad": (60, 1, 6272, 64, "ones"),
    "fc1_fwd": (60, 32, 3136, 512, "nn"),
    "fc1_wgrad": (60, 3136, 32, 512, "tn"),
    "fc1_dgrad": (60, 32, 512, 3136, "nt"),
    "fedavg_fc1": (6, 1, 10, 1605632, "wbc"),
    "paper_conv2_fwd": (10, 3136, 800, 64, "nn"),
    "paper_fc1_fwd": (10, 16, 3136, 512, "nn"),
    "paper_fc2_fwd": (10, 16, 512, 10, "nn"),
    "paper_fc1_dgrad": (10, 16, 512, 3136, "nt"),
    "paper_conv2_wgrad": (10, 800, 3136, 64, "tn"),
    "paper_conv2_bias": (10, 1, 3136, 64, "ones"),
    "paper_conv1_wgrad": (10, 25, 12544, 32, "tn"),
    "paper_conv1_bias": (10, 1, 12544, 32, "ones"),
    "loop_conv2_fwd": (1, 3136, 800, 64, "nn"),
    "loop_conv2_wgrad": (1, 800, 3136, 64, "tn"),
    "loop_fc1_fwd": (1, 16, 3136, 512, "nn"),
    "loop_conv1_wgrad": (1, 25, 12544, 32, "tn"),
    "async_conv2_fwd": (1, 1568, 800, 64, "nn"),
    "async_conv2_wgrad": (1, 800, 1568, 64, "tn"),
    "async_fc1_fwd": (1, 8, 3136, 512, "nn"),
    "async_conv1_wgrad": (1, 25, 6272, 32, "tn"),
    "sampled_conv2_fwd": (50, 6272, 800, 64, "nn"),
    "sampled_conv2_wgrad": (50, 800, 6272, 64, "tn"),
    "sampled_conv1_wgrad": (50, 25, 25088, 32, "tn"),
}
FOLD_TIMED = "conv2_wgrad"
FOLD_RTOL = 1e-4
# A chain of K dependent fmas takes at least K x this many cycles of the
# SM clock (the float32 fma's latency on Hopper).
FMA_LATENCY_CYCLES = 4


def fold_inputs(name, dev):
    import torch
    batch, M, K, N, layout = FOLD_CASES[name]
    g = torch.Generator(device=dev).manual_seed(len(name))
    if layout == "ones":
        a = torch.ones((), device=dev).expand(batch, M, K)
    elif layout == "wbc":
        a = torch.rand((1, M, K), generator=g, device=dev).expand(batch, M, K)
    elif layout == "tn":
        a = torch.randn((batch, K, M), generator=g, device=dev).transpose(1, 2)
    else:
        a = torch.randn((batch, M, K), generator=g, device=dev)
    if layout == "nt":
        b = torch.randn((batch, N, K), generator=g, device=dev).transpose(1, 2)
    else:
        b = torch.randn((batch, K, N), generator=g, device=dev)
    return a, b


def sm_clock_hz():
    """The card's highest SM clock (nvidia-smi clocks.max.sm), in Hz."""
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60)
    return float(res.stdout.strip().splitlines()[0]) * 1e6


def fold_work(batch, M, K, N, layout):
    """(bytes, operations) of a fold matmul case: each operand read once and
    C written once; 2 M N K float32 operations."""
    a_elems = (1 if layout == "ones" else M * K if layout == "wbc"
               else batch * M * K)
    return (4 * (a_elems + batch * K * N + batch * M * N),
            2 * batch * M * N * K)


def same_bits(x, y):
    """Equal bit for bit, signs of zero and NaN payloads included."""
    import torch
    return torch.equal(x.contiguous().view(torch.int32),
                       y.contiguous().view(torch.int32))


def phase_fold_matmul_kernel(dev, card):
    """The fold matmul against its plain version (torch.matmul, TF32 off)
    at the Study group's and the main path's shapes; every route bit for
    bit against the row route (the oracle), and its defining property: the
    rows of a call do not move when it has more rows or K is padded with
    zeros."""
    import torch
    from repro_torch.kernels.fold_matmul import ops, ref
    sm_hz = sm_clock_hz()
    print(f"[kernel] fold_matmul: chain bound at {FMA_LATENCY_CYCLES} cycles "
          f"a fma and the SM's highest clock, {sm_hz / 1e6:.0f} MHz",
          flush=True)
    max_err, timed = 0.0, {}
    for name, (batch, M, K, N, layout) in FOLD_CASES.items():
        a, b = fold_inputs(name, dev)
        route = ops.route_for(batch, M, N, K)
        instance = ops.instance_for(route, batch, M, N)
        c = ops.fold_matmul(a, b)
        oracle = ops.fold_matmul(a, b, route="rows")
        torch.cuda.synchronize()
        plain = ref.fold_matmul_ref(a, b)
        err = float((c - plain).abs().max())
        scale = max(1.0, float(plain.abs().max()))
        max_err = max(max_err, err)
        # Every route, bit for bit against the row route.
        routes = {r: same_bits(ops.fold_matmul(a, b, route=r), oracle)
                  for r in ("tiles", "panel")}
        # More rows (M), and K padded with zeros: the first rows agree bit
        # for bit.
        m = max(1, M // 2)
        half = ops.fold_matmul(a[:, :m], b)
        pad = 16 + K % 16
        a_pad = torch.cat([a, a.new_zeros(batch, M, pad)], dim=2)
        b_pad = torch.cat([b, b.new_zeros(batch, pad, N)], dim=1)
        padded = ops.fold_matmul(a_pad, b_pad)
        stable = same_bits(half, c[:, :m]) and same_bits(padded, c)
        print(f"[kernel] fold_matmul {name} ({batch}, {M}, {K}) @ ({batch}, "
              f"{K}, {N}) {layout}, {route} route ({instance}): max |kernel "
              f"- plain| {err:.3g} (scale {scale:.3g}, tol {FOLD_RTOL:g} of "
              f"it); tiles and panel equal to rows as int32: {routes}; rows "
              f"unmoved by more rows and by {pad} zero k: {stable}",
              flush=True)
        if (not err <= FOLD_RTOL * scale or not stable
                or not all(routes.values())):
            raise SystemExit(f"fold_matmul disagrees or is not stable on "
                             f"{name}")
        ms = time_ms(lambda: ops.fold_matmul(a, b), warmup=2, calls=5, reps=5)
        rows_ms = time_ms(lambda: ops.fold_matmul(a, b, route="rows"),
                          warmup=2, calls=5, reps=5)
        plain_ms = time_ms(lambda: ref.fold_matmul_ref(a, b), warmup=2,
                           calls=5, reps=5)
        library_ms = time_ms(lambda: torch.bmm(a, b), warmup=2, calls=5,
                             reps=5)
        on_dev = [device_ms(fn) for fn in (
            lambda: ops.fold_matmul(a, b),
            lambda: ops.fold_matmul(a, b, route="rows"),
            lambda: torch.bmm(a, b))]
        n_bytes, n_ops = fold_work(batch, M, K, N, layout)
        terms = {"bytes": n_bytes / HBM_BYTES_PER_S * 1e3,
                 "operations": n_ops / FP32_OPS_PER_S * 1e3,
                 "chain": K * FMA_LATENCY_CYCLES / sm_hz * 1e3}
        binds = max(terms, key=terms.get)
        print(f"[kernel] fold_matmul {name} on {card}: {route} "
              f"({instance}) {ms:.4f} ms ({on_dev[0]:.4f} on the device), "
              f"rows {rows_ms:.4f} ms ({on_dev[1]:.4f}), plain "
              f"{plain_ms:.4f} ms, torch.bmm {library_ms:.4f} ms "
              f"({on_dev[2]:.4f}), bound "
              f"{terms[binds]:.4f} ms ({binds}; bytes {terms['bytes']:.4f}, "
              f"operations {terms['operations']:.4f}, chain "
              f"{terms['chain']:.4f}), {terms[binds] / on_dev[0]:.1%} of bound "
              "on the device", flush=True)
        # The JSON line's bound: bytes or operations, as for every kernel.
        bound_ms, bound_by = bound(n_bytes, n_ops, FP32_OPS_PER_S)
        timed[name] = (ms, plain_ms, bound_ms, bound_by, library_ms)
        del a, b, c, oracle, plain, half, a_pad, b_pad, padded
    ms, plain_ms, bound_ms, bound_by, library_ms = timed[FOLD_TIMED]
    return {"name": "fold_matmul", "route": "cuda",
            "source": "src/repro_torch/kernels/fold_matmul/csrc/"
                      "fold_matmul.cu",
            "replaces": "src/repro/models/cnn.py:82",
            "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms}


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
    # The serve paths' shapes: qwen2-0.5b's prefill attention, gemma-7b's
    # (hd 256, MHA) and zamba2-2.7b's shared block's (hd 80, MHA).
    "qwen2_prefill_bf16": (SERVE_BATCH, SERVE_PROMPT, SERVE_PROMPT, 14, 2, 64,
                           "bfloat16", True, None, 0),
    "gemma_prefill_bf16": (SERVE_BATCH, SERVE_PROMPT, SERVE_PROMPT, 16, 16,
                           256, "bfloat16", True, None, 0),
    "zamba2_shared_prefill_bf16": (SERVE_BATCH, SERVE_PROMPT, SERVE_PROMPT,
                                   32, 32, 80, "bfloat16", True, None, 0),
    # musicgen-large's prefill attention (hd 64, MHA of 32 heads).
    "musicgen_prefill_bf16": (SERVE_BATCH, SERVE_PROMPT, SERVE_PROMPT, 32,
                              32, 64, "bfloat16", True, None, 0),
    # qwen3-moe-30b-a3b's prefill attention (hd 128, 32 heads over 4 kv
    # heads: a GQA group of 8), its float32 prompt of phase 25's float32
    # check, and moonshot-v1-16b-a3b's MHA of 16 heads at hd 128.
    "qwen3moe_prefill_bf16": (SERVE_BATCH, SERVE_PROMPT, SERVE_PROMPT, 32, 4,
                              128, "bfloat16", True, None, 0),
    "qwen3moe_prompt_f32": (SERVE_BATCH, 256, 256, 32, 4, 128, "float32",
                            True, None, 0),
    "moonshot_mha_hd128_bf16": (2, 1024, 1024, 16, 16, 128, "bfloat16", True,
                                None, 0),
    # hd 256 and 80 in both kernels: causal, not causal with a ragged Sk,
    # windowed, and q_offset (Sq != Sk); the float32 kernel at one prompt
    # of the serve shapes.
    "hd256_bf16": (2, 200, 200, 4, 4, 256, "bfloat16", True, None, 0),
    "hd256_f32": (2, 200, 200, 4, 4, 256, "float32", True, None, 0),
    "hd256_not_causal_bf16": (1, 100, 130, 2, 1, 256, "bfloat16", False,
                              None, 0),
    "hd256_not_causal_f32": (1, 100, 130, 2, 1, 256, "float32", False, None,
                             0),
    "hd256_window64_bf16": (1, 384, 384, 4, 2, 256, "bfloat16", True, 64, 0),
    "hd256_window64_f32": (1, 384, 384, 4, 2, 256, "float32", True, 64, 0),
    "hd256_q_offset_bf16": (2, 64, 200, 4, 2, 256, "bfloat16", True, None,
                            136),
    "hd256_q_offset_window_f32": (1, 100, 300, 4, 2, 256, "float32", True, 64,
                                  200),
    "hd256_gemma_prompt_f32": (1, SERVE_PROMPT, SERVE_PROMPT, 16, 16, 256,
                               "float32", True, None, 0),
    "hd80_bf16": (2, 200, 200, 4, 4, 80, "bfloat16", True, None, 0),
    "hd80_f32": (2, 200, 200, 4, 4, 80, "float32", True, None, 0),
    "hd80_not_causal_bf16": (1, 100, 130, 2, 1, 80, "bfloat16", False, None,
                             0),
    "hd80_not_causal_f32": (1, 100, 130, 2, 1, 80, "float32", False, None, 0),
    "hd80_window64_bf16": (1, 384, 384, 4, 2, 80, "bfloat16", True, 64, 0),
    "hd80_window64_f32": (1, 384, 384, 4, 2, 80, "float32", True, 64, 0),
    "hd80_q_offset_bf16": (2, 64, 200, 4, 2, 80, "bfloat16", True, None, 136),
    "hd80_q_offset_window_f32": (1, 100, 300, 4, 2, 80, "float32", True, 64,
                                 200),
    "hd80_zamba2_prompt_f32": (1, SERVE_PROMPT, SERVE_PROMPT, 32, 32, 80,
                               "float32", True, None, 0),
}
# The cases timed: the serve paths' prefill shapes, bf16, causal.
FLASH_TIMED = ("qwen2_prefill_bf16", "gemma_prefill_bf16",
               "zamba2_shared_prefill_bf16", "musicgen_prefill_bf16",
               "qwen3moe_prefill_bf16")
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
    timed = {name: time_flash(name, dev, card) for name in FLASH_TIMED}
    ms, plain_ms, library_ms, bound_ms, bound_by = timed["qwen2_prefill_bf16"]
    return {"name": "flash_attention", "route": "cuda",
            "source": ("src/repro_torch/kernels/flash_attention/csrc/"
                       "flash_attention.cu"),
            "replaces": "src/repro/kernels/flash_attention/kernel.py:24",
            "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms}


def time_flash(name, dev, card):
    """The kernel's time at case `name` beside its plain version's, the
    library call's and the card's bound: (ms, plain_ms, library_ms,
    bound_ms, bound_by)."""
    import torch
    from repro_torch.kernels.flash_attention import ops, ref
    q, k, v = flash_inputs(name, dev)
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
    print(f"[kernel] flash_attention {name} {tuple(q.shape)} kv "
          f"{tuple(k.shape)} bf16 causal on {card}: kernel {ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms, scaled_dot_product_attention "
          f"{library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}; "
          f"{n_ops:.4g} FLOPs at the bf16 peak, {n_bytes / 1e6:.1f} MB), "
          f"{bound_ms / ms:.1%} of bound", flush=True)
    return ms, plain_ms, library_ms, bound_ms, bound_by


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
    print_fold_time(tag, top, busy, 3)
    return {"launches": launches, "s_per_round": statistics.median(per_round),
            "busy": busy / wall, "history": res.history}


def _card_and_cpu(counters, spec, rounds, eval_every):
    """`spec` run for `rounds` on the card and on the CPU from the same
    model and the same quantizer noise (one CPU generator's draws, moved
    to each device): ({"cuda": (state, result), "cpu": (state, result)},
    the card run's launches); the card result's params are copied to the
    CPU."""
    import torch
    from repro_torch.kernels.quantize import ref
    from repro_torch.utils.tree import tree_map
    out, launches = {}, None
    for d in ("cuda", "cpu"):
        noise_gen = torch.Generator().manual_seed(7)

        def noise(_generator, shape, d=d, noise_gen=noise_gen):
            return ref.stochastic_noise(noise_gen, shape).to(d)

        sim = spec.build(device=d, noise=noise)
        out[d], n = _launched(counters, lambda: sim.run(
            sim.init(), max_rounds=rounds, eval_every=eval_every))
        launches = n if d == "cuda" else launches
    st, res = out["cuda"]
    out["cuda"] = (st, dataclasses.replace(res, params=tree_map(
        lambda x: x.cpu(), res.params)))
    return out, launches


def phase_fl_reference(counters):
    """mnist_smoke on the card and on the CPU, on a small input."""
    from repro_torch.utils.tree import leaves
    runs, _ = _card_and_cpu(counters, compressed_spec("mnist_smoke"), 3, 2)
    out = {d: res for d, (_, res) in runs.items()}
    losses = [[h.train_loss for h in out[d].history] for d in ("cuda", "cpu")]
    worst_loss = max(abs(a - b) / abs(b) for a, b in zip(*losses))
    worst_param = max(
        float((a - b).abs().max())
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


# The fields of a RoundRecord that a member's run alone fixes exactly.
RECORD_FIELDS = ("round", "sim_time", "T_cm", "T_cp", "uplink_bits",
                 "n_participants", "rejected")


def _records(res):
    return [tuple(getattr(r, f) for f in RECORD_FIELDS) for r in res.history]


def _gaps(a, b):
    """(clock, bits, participants and rounds equal, max relative
    train-loss gap, max param gap, bit-identical) of two SimResults."""
    from repro_torch.utils.tree import leaves
    exact = _records(a) == _records(b)
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
    print_fold_time("fleet", top, busy, 3)
    return launches


def phase_quickstart(counters):
    """examples/quickstart_torch.py's main on the card, through its fleet
    summary (uncompressed: the fold matmul launches, no other kernel)."""
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
    _check_uncompressed("quickstart", launches)
    if not (len(res.history) == 5 and len(fleet) == 4
            and all(math.isfinite(v) for v in summary.values())):
        raise SystemExit(f"the quickstart twin did not finish: {summary}")
    return launches


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


def _check_uncompressed(tag, launches):
    """An uncompressed FL path: the fold matmul launches (every product of
    the CNN's local steps, FedAvg and eval), no other kernel does."""
    if not launches["fold_matmul"] or any(
            n for k, n in launches.items() if k != "fold_matmul"):
        raise SystemExit(f"[{tag}] an uncompressed FL path must launch the "
                         f"fold matmul and nothing else: {launches}")


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


# -- the per-round backends (phase 18) -------------------------------------------

# The full record of a round, for runs that must repeat each other exactly.
FULL_RECORD_FIELDS = RECORD_FIELDS + ("train_loss", "test_acc")
# loop against batched (the reference's tests/test_simulation_backends.py):
# losses within 1e-5 relative; params within 2e-3 compressed (a flipped
# stochastic-rounding code moves a weight by one quantizer step) and
# 1e-5 uncompressed.
LOOP_LOSS_RTOL = 1e-5
LOOP_PARAM_ATOL = {True: 2e-3, False: 1e-5}


def _full_records(res):
    return [tuple(getattr(r, f) for f in FULL_RECORD_FIELDS)
            for r in res.history]


def _params_same(a, b):
    from repro_torch.utils.tree import leaves
    return all(same_bits(x, y) for x, y in zip(leaves(a), leaves(b)))


def _params_gap(a, b):
    from repro_torch.utils.tree import leaves
    return max(float((x - y).abs().max()) for x, y in zip(leaves(a),
                                                          leaves(b)))


def _check_loop_rounds(tag, launches, participants):
    """A compressed loop round quantizes each participant alone: one launch
    a participating client a round."""
    if launches["quantize"] != sum(participants):
        raise SystemExit(f"[{tag}] expected one quantize launch a "
                         f"participating client ({sum(participants)} in "
                         f"{len(participants)} rounds), got "
                         f"{launches['quantize']}")


def _loop_vs_batched(tag, loop, batched, compressed):
    """loop against batched: clock, bits and rounds exact, losses within
    LOOP_LOSS_RTOL, params within LOOP_PARAM_ATOL; bit identity printed."""
    exact, loss, param, _ = _gaps(loop, batched)
    same = _params_same(loop.params, batched.params)
    atol = LOOP_PARAM_ATOL[compressed]
    print(f"[{tag}] loop vs batched: clock, bits and rounds exact {exact}; "
          f"max rel loss gap {loss:.3g} (tol {LOOP_LOSS_RTOL:g}); params gap "
          f"{param:.3g} (tol {atol:g}); params bit for bit {same}; losses "
          f"equal {[x.train_loss == y.train_loss for x, y in zip(loop.history, batched.history)]}",
          flush=True)
    if not (exact and loss <= LOOP_LOSS_RTOL and param <= atol):
        raise SystemExit(f"[{tag}] the loop backend breaks its contract "
                         "against the batched one")
    return same


def phase_backends(counters, card, paper):
    """18 (a): compressed mnist_paper on each synchronous backend for 3
    rounds: batched bit for bit against scan (and phase 4's records), loop
    within the reference's contract against batched; launches per round."""
    import torch
    spec = compressed_spec("mnist_paper")
    runs, fl_launches = {}, []
    for backend in ("scan", "batched", "loop"):
        sim = spec.replace(backend=backend).build()
        if sim.device.type != "cuda":
            raise SystemExit(f"the {backend} backend was built on "
                             f"{sim.device}")
        t0 = time.perf_counter()
        (_, res), launches = _launched(counters, lambda: sim.run(
            sim.init(), max_rounds=3, eval_every=3))
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        fl_launches.append(launches)
        runs[backend] = res
        print(f"[backends] {backend}: 3 rounds of compressed mnist_paper in "
              f"{elapsed:.4f} s (warm-up included), launches {launches}, "
              f"losses {[r.train_loss for r in res.history]}", flush=True)
        if backend == "loop":
            _check_loop_rounds("backends", launches,
                               [spec.fed.n_devices] * 3)
        else:
            _check_quantize_rounds("backends", launches, 3)
        if not all(math.isfinite(r.train_loss) for r in res.history):
            raise SystemExit(f"non-finite train loss on {backend}")
    same = (_full_records(runs["batched"]) == _full_records(runs["scan"])
            == [tuple(getattr(r, f) for f in FULL_RECORD_FIELDS)
                for r in paper["history"][:3]])
    bits = _params_same(runs["batched"].params, runs["scan"].params)
    print(f"[backends] batched vs scan (and phase 4's first 3 records): "
          f"records equal {same}, params bit for bit {bits}", flush=True)
    if not (same and bits):
        raise SystemExit("the batched backend differs from scan")
    loop_bits = _loop_vs_batched("backends", runs["loop"], runs["batched"],
                                 True)
    # run_round x3 on the loop backend: run()'s rounds, bit for bit.
    sim = spec.replace(backend="loop").build()
    state, losses = sim.init(), []

    def three_rounds():
        nonlocal state
        for _ in range(3):
            state, m = sim.run_round(state)
            losses.append(m["train_loss"])

    _, launches = _launched(counters, three_rounds)
    fl_launches.append(launches)
    _check_loop_rounds("backends", launches, [spec.fed.n_devices] * 3)
    rr = (losses == [r.train_loss for r in runs["loop"].history]
          and _params_same(sim.params(state), runs["loop"].params))
    print(f"[backends] loop run_round x3: launches {launches}, losses and "
          f"params equal to run()'s {rr}", flush=True)
    if not rr:
        raise SystemExit("loop run_round x3 differs from run()")
    return fl_launches, loop_bits


def phase_backends_uncompressed(counters):
    """18 (b): uncompressed mnist_paper, loop against batched, 3 rounds:
    the fold matmul is the only kernel."""
    from repro_torch.federated import experiment
    spec = experiment.get("mnist_paper")
    res, fl_launches = {}, []
    for backend in ("batched", "loop"):
        sim = spec.replace(backend=backend).build()
        (_, res[backend]), launches = _launched(counters, lambda: sim.run(
            sim.init(), max_rounds=3, eval_every=3))
        _check_uncompressed(f"backends-uncompressed {backend}", launches)
        fl_launches.append(launches)
        print(f"[backends-uncompressed] {backend}: launches {launches}, "
              f"losses {[r.train_loss for r in res[backend].history]}",
              flush=True)
    _loop_vs_batched("backends-uncompressed", res["loop"], res["batched"],
                     False)
    return fl_launches


def phase_backends_checkpoint(counters):
    """18 (c): per backend, 3 rounds, save_state, load_state into a fresh
    simulator, 3 more rounds: records and params bit for bit against an
    uninterrupted 6-round run; the card's checkpoint refused by a CPU
    simulator."""
    import tempfile
    from repro_torch.federated.simulation import load_state, save_state
    spec = compressed_spec("mnist_paper")
    fl_launches = []
    with tempfile.TemporaryDirectory() as tmp:
        for backend in ("scan", "batched", "loop"):
            b_spec = spec.replace(backend=backend)

            def run_both():
                full_sim = b_spec.build()
                _, full = full_sim.run(full_sim.init(5), max_rounds=6,
                                       eval_every=3)
                first = b_spec.build()
                mid, _ = first.run(first.init(5), max_rounds=3, eval_every=3)
                path = str(Path(tmp) / f"{backend}.pkl")
                save_state(path, mid)
                fresh = b_spec.build()
                restored = load_state(path, like=fresh.init())
                _, tail = fresh.run(restored, max_rounds=3, eval_every=3)
                return full, tail, path

            (full, tail, path), launches = _launched(counters, run_both)
            fl_launches.append(launches)
            same = (_full_records(tail) == _full_records(full)[3:]
                    and _params_same(tail.params, full.params))
            print(f"[backends-checkpoint] {backend}: 3 rounds, save_state, "
                  f"load_state into a fresh simulator, 3 rounds: records "
                  f"and params bit for bit against 6 rounds alone {same}",
                  flush=True)
            if not same:
                raise SystemExit(f"checkpoint resume on {backend} differs "
                                 "from the uninterrupted run")
        cpu = spec.replace(backend="loop").build(device="cpu")
        refused = []
        for attempt in (lambda: load_state(path, like=cpu.init()),
                        lambda: cpu.run(load_state(path), max_rounds=1)):
            try:
                attempt()
            except ValueError as e:
                refused.append("generator" in str(e))
            else:
                refused.append(False)
        print(f"[backends-checkpoint] the card's checkpoint into a CPU "
              f"simulator: load_state(like=) and run refuse it with the "
              f"generator-kind ValueError {refused}", flush=True)
        if not all(refused):
            raise SystemExit("a CPU simulator took the card's checkpoint")
    return fl_launches


def phase_backends_cost(counters, card, paper):
    """18 (d): steady-state s/round of loop and batched beside phase 4's
    scan, and one profiled loop round (none a gate)."""
    import torch
    spec = compressed_spec("mnist_paper").replace(with_eval=False)
    out = {}
    for backend in ("batched", "loop"):
        sim = spec.replace(backend=backend).build()
        state, _ = sim.run(sim.init(), max_rounds=2)  # warm-up
        per_round = []
        for _ in range(2):  # 6 timed rounds: 2 runs of 3 (phase 4's chunks)
            t0 = time.perf_counter()
            state, _ = sim.run(state, max_rounds=3, eval_every=3)
            per_round.append((time.perf_counter() - t0) / 3)
        out[backend] = (sim, state, per_round)
    print(f"[backends] steady state on {card}, 6 rounds each (2 runs of 3, "
          f"no eval): batched {statistics.median(out['batched'][2])!r} s per "
          f"round, loop {statistics.median(out['loop'][2])!r} (runs "
          f"{out['batched'][2]!r} and {out['loop'][2]!r}); scan "
          f"{paper['s_per_round']!r} (phase 4)", flush=True)
    sim, state, _ = out["loop"]
    for ops in counters.values():
        ops.launches = 0
    _, wall, busy, top = profiled(lambda: sim.run(state, max_rounds=1))
    launches = {k: ops.launches for k, ops in counters.items()}
    print(f"[backends] one profiled loop round on {card}: wall {wall:.4f} s, "
          f"device busy {busy:.4f} s ({busy / wall:.1%}), launches "
          f"{launches}, profiler on", flush=True)
    for kname, sec in top[:6]:
        print(f"[backends]   {sec * 1e3:9.3f} ms/round {sec / busy:6.1%}  "
              f"{kname[:90]}")
    print_fold_time("backends", top, busy, 1)
    return launches


# -- sampled participation (phase 19) --------------------------------------------

# (b)-(d), (f): compressed mnist_paper over a population of SAMPLED_M
# clients, a cohort of SAMPLED_K drawn each round (virtual data shards:
# SAMPLED_M > n_train), and in (c) SAMPLED_SPARE spare candidates a round.
SAMPLED_M, SAMPLED_K, SAMPLED_SPARE = 10_000, 50, 10
# The record of a sampled run against a dense one: every field but the
# participant count (None on a scenario-less dense run: all M).
DENSE_FIELDS = ("round", "sim_time", "T_cm", "T_cp", "uplink_bits",
                "rejected", "train_loss", "test_acc")
# (f): timed chunks of 3 rounds, after one chunk of warm-up.
SAMPLED_TIMED_CHUNKS = 4
# The reference's CPU gate on sampled throughput against a dense run of K
# clients (benchmarks/bench_round_step.py): printed against, not a gate.
SAMPLED_REF_GATE = 0.9


def sampled_spec(M, K, spare=0, **kw):
    """Compressed mnist_paper with a population of M and cohorts of K."""
    from repro_torch.federated.experiment import CohortSpec, PopulationSpec
    return compressed_spec("mnist_paper").replace(
        population=PopulationSpec(M=M, cohort=CohortSpec(K=K, spare=spare)),
        **kw)


def _quantize_rows(fn):
    """fn() with the rows of every quantize call recorded: (its result,
    [rows of each call])."""
    from repro_torch.kernels.quantize import ops
    real, rows = ops.quantize, []

    def recording(x, u):
        rows.append(int(x.shape[0]))
        return real(x, u)

    ops.quantize = recording
    try:
        return fn(), rows
    finally:
        ops.quantize = real


def _state_bytes(state):
    """Bytes of a SimState's device state: its params, optimizer state and
    noise generator."""
    from repro_torch.utils.tree import leaves
    return sum(x.numel() * x.element_size()
               for x in leaves((state.params_C, state.opt_C, state.rng)))


def _on_card(sim, what):
    if sim.device.type != "cuda":
        raise SystemExit(f"{what} was built on {sim.device}")
    return sim


def phase_sampled_dense(counters, paper):
    """19 (a): K = M = 10 sampled on scan and batched, 3 rounds: the
    records (every field but the participant count) equal phase 4's first
    3, and the params a dense run's of 3 rounds, bit for bit."""
    dense = _on_card(compressed_spec("mnist_paper").build(), "dense")
    _, dense_res = dense.run(dense.init(), max_rounds=3, eval_every=3)
    want = [tuple(getattr(r, f) for f in DENSE_FIELDS)
            for r in paper["history"][:3]]
    M = dense.fed.n_devices
    fl_launches = []
    for backend in ("scan", "batched"):
        spec = sampled_spec(M, M, backend=backend)
        sim = _on_card(spec.build(), f"sampled {backend}")
        (_, res), launches = _launched(counters, lambda: sim.run(
            sim.init(), max_rounds=3, eval_every=3))
        _check_quantize_rounds("sampled", launches, 3)
        fl_launches.append(launches)
        got = [tuple(getattr(r, f) for f in DENSE_FIELDS)
               for r in res.history]
        parts = [r.n_participants for r in res.history]
        same = (got == want and parts == [M] * 3
                and _params_same(res.params, dense_res.params))
        print(f"[sampled] (a) K = M = {M}, {backend}: launches {launches}; "
              f"records equal phase 4's first 3 (participants {parts}) and "
              f"params a dense run's, bit for bit: {same}", flush=True)
        if not same:
            raise SystemExit(f"sampled K = M on {backend} differs from the "
                             "dense run")
    return fl_launches


def phase_sampled_scale(counters, card):
    """19 (b): K = 50 of M = 10,000 (virtual shards), 3 rounds on scan and
    batched: bit for bit equal, one quantize launch a round over K x rows,
    K lanes in every leaf of params_C, and the state's bytes those of a
    dense M = K build (the O(K) gate)."""
    import torch
    from repro_torch.federated import compression
    from repro_torch.federated.experiment import PopulationSpec
    from repro_torch.utils.tree import leaves
    runs, fl_launches = {}, []
    for backend in ("scan", "batched"):
        sim = _on_card(sampled_spec(SAMPLED_M, SAMPLED_K,
                                    backend=backend).build(),
                       f"sampled {backend}")
        pool = sim._data_src(0)
        if not (hasattr(pool, "client") and len(pool) == SAMPLED_M):
            raise SystemExit("the M = 10,000 build did not take the pooled "
                             "virtual-shard data path")
        rows = compression.n_rows(sim.params(sim.init()))
        t0 = time.perf_counter()
        ((state, res), q_rows), launches = _launched(
            counters, lambda: _quantize_rows(lambda: sim.run(
                sim.init(), max_rounds=3, eval_every=3)))
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        fl_launches.append(launches)
        lanes = {leaf.shape[0] for leaf in leaves(state.params_C)}
        print(f"[sampled] (b) K = {SAMPLED_K} of M = {SAMPLED_M}, "
              f"{backend}: 3 rounds in {elapsed:.4f} s (warm-up included), "
              f"b={sim.fed.batch_size} V={sim.fed.local_rounds}, launches "
              f"{launches}, quantize rows a launch {q_rows}, participants "
              f"{[r.n_participants for r in res.history]}, lanes {lanes}, "
              f"losses {[r.train_loss for r in res.history]}", flush=True)
        _check_quantize_rounds("sampled", launches, 3)
        if q_rows != [SAMPLED_K * rows] * 3 or lanes != {SAMPLED_K}:
            raise SystemExit("a sampled round must quantize K x rows in one "
                             "launch and hold K lanes")
        if not all(math.isfinite(r.train_loss) for r in res.history):
            raise SystemExit("non-finite train loss on the sampled path")
        runs[backend] = (sim, state, res)
    same = (_full_records(runs["scan"][2]) == _full_records(runs["batched"][2])
            and _params_same(runs["scan"][2].params,
                             runs["batched"][2].params))
    dense = _on_card(compressed_spec("mnist_paper").replace(
        population=PopulationSpec(M=SAMPLED_K)).build(), "dense M = K")
    sampled_bytes = _state_bytes(runs["scan"][1])
    dense_bytes = _state_bytes(dense.init())
    print(f"[sampled] (b) scan vs batched: records and params bit for bit "
          f"{same}; state bytes {sampled_bytes:,} sampled vs {dense_bytes:,} "
          f"dense M = {SAMPLED_K} (a dense M = {SAMPLED_M} would hold "
          f"{dense_bytes // SAMPLED_K * SAMPLED_M:,})", flush=True)
    if not same:
        raise SystemExit("sampled batched differs from sampled scan")
    if sampled_bytes != dense_bytes:
        raise SystemExit("the sampled state is not O(K)")
    return fl_launches, runs["scan"], dense


def _kept_cohorts(sim, cands, t_cm):
    """The K kept of each round's candidates, recomputed on the host from
    the definition: feasible before infeasible (finish V t_cp + t_cm past
    the deadline), then the fastest, ties by client id; sorted."""
    V, K = sim.fed.local_rounds, sim._cohort
    deadline = math.inf if sim._deadline is None else sim._deadline
    out = []
    for r, row in enumerate(cands):
        finish = [V * sim._t_cp_clients[c] + t_cm[r, c] for c in row]
        keyed = sorted((bool(f > deadline), f, int(c))
                       for f, c in zip(finish, row))
        out.append(sorted(c for _, _, c in keyed[:K]))
    return out


def phase_sampled_spare(counters):
    """19 (c): CohortSpec(K=50, spare=10) under unreliable_edge: 3 rounds,
    save_state, load_state into a fresh build, 3 more, bit for bit against
    6 rounds alone; the kept cohorts those of a host recomputation, and
    the clients whose data advanced exactly the kept ones."""
    import tempfile
    from repro_torch.federated.simulation import load_state, save_state
    spec = sampled_spec(SAMPLED_M, SAMPLED_K, SAMPLED_SPARE,
                        scenario="unreliable_edge")

    def run_both(tmp):
        full_sim = _on_card(spec.build(), "spare cohorts")
        full_state, full = full_sim.run(full_sim.init(5), max_rounds=6,
                                        eval_every=3)
        first = spec.build()
        mid, _ = first.run(first.init(5), max_rounds=3, eval_every=3)
        path = str(Path(tmp) / "spare.pkl")
        save_state(path, mid)
        fresh = spec.build()
        _, tail = fresh.run(load_state(path, like=fresh.init()),
                            max_rounds=3, eval_every=3)
        return full_sim, full_state, full, tail

    with tempfile.TemporaryDirectory() as tmp:
        (sim, state, full, tail), launches = _launched(
            counters, lambda: run_both(tmp))
    _check_quantize_rounds("sampled", launches, 12)
    same = (_full_records(tail) == _full_records(full)[3:]
            and _params_same(tail.params, full.params))
    _, stream = sim._materialize(sim.init(5))
    cands = stream.draw_cohorts(6)
    _, t_cm = sim._chunk_uplink(stream.draw_chunk(6))
    kept = sim._select_cohorts(cands, t_cm)
    host = _kept_cohorts(sim, cands, t_cm)
    touched = set(state.data["clients"])
    agree = ([list(map(int, r)) for r in kept] == host
             and touched == {c for r in host for c in r})
    print(f"[sampled] (c) K = {SAMPLED_K} + {SAMPLED_SPARE} spare under "
          f"unreliable_edge: launches {launches}; participants "
          f"{[r.n_participants for r in full.history]}; 3 rounds, "
          f"save_state, load_state, 3 rounds: records and params bit for bit "
          f"against 6 rounds alone {same}; kept cohorts equal the host's "
          f"recomputation and the {len(touched)} clients whose data advanced "
          f"{agree}", flush=True)
    if not (same and agree):
        raise SystemExit("spare-cohort resume or selection is wrong")
    return launches


def phase_sampled_fleet(counters, card):
    """19 (d): run_fleet of 4 seeds of (b): one quantize launch a round
    over S x K x rows; each member its run alone, bit for bit."""
    import torch
    sim = _on_card(sampled_spec(SAMPLED_M, SAMPLED_K).build(), "fleet")
    t0 = time.perf_counter()
    (fleet, q_rows), launches = _launched(counters, lambda: _quantize_rows(
        lambda: sim.run_fleet(seeds=FLEET_SEEDS, max_rounds=3,
                              eval_every=3)))
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    _check_quantize_rounds("sampled", launches, 3)
    alone = [sim.run(sim.init(s), max_rounds=3, eval_every=3)[1]
             for s in FLEET_SEEDS]
    same = [_full_records(f) == _full_records(a)
            and _params_same(f.params, a.params)
            for f, a in zip(fleet.results, alone)]
    print(f"[sampled] (d) run_fleet(seeds=range({len(FLEET_SEEDS)})) of (b) "
          f"on {card}: 3 rounds in {elapsed:.4f} s (warm-up included), "
          f"launches {launches}, quantize rows a launch {q_rows}; each "
          f"member its run alone bit for bit {same}", flush=True)
    rows = q_rows[0] // (len(FLEET_SEEDS) * SAMPLED_K)
    if q_rows != [len(FLEET_SEEDS) * SAMPLED_K * rows] * 3 or not all(same):
        raise SystemExit("the sampled fleet breaks phase 11's contract")
    return launches


def phase_sampled_reference(counters):
    """19 (e): compressed mnist_sampled, 4 rounds, on the card and on the
    CPU from the same model and quantizer noise: cohorts (the host streams
    and the clients whose data advanced), clock, bits and participants
    exact; losses and params within phase 5's tolerances."""
    from repro_torch.utils.tree import leaves
    out, card_launches = _card_and_cpu(
        counters, compressed_spec("mnist_sampled"), 4, 2)
    (c_st, c_res), (h_st, h_res) = out["cuda"], out["cpu"]
    _check_quantize_rounds("sampled", card_launches, 4)
    exact = (_records(c_res) == _records(h_res)
             and repr(c_st.stream) == repr(h_st.stream)
             and repr(c_st.data) == repr(h_st.data))
    loss = max(abs(a.train_loss - b.train_loss) / abs(b.train_loss)
               for a, b in zip(c_res.history, h_res.history))
    param = max(float((a - b).abs().max())
                for a, b in zip(leaves(c_res.params), leaves(h_res.params)))
    print(f"[sampled] (e) mnist_sampled card vs CPU, 4 rounds: launches "
          f"{card_launches}; cohorts, clock, bits and participants exact "
          f"{exact} (participants {[r.n_participants for r in c_res.history]}"
          f"); max rel loss gap {loss:.3g} (tol 1e-5), max param gap "
          f"{param:.3g} (tol 5e-4)", flush=True)
    if not exact or loss > 1e-5 or param > 5e-4:
        raise SystemExit("the card's sampled run disagrees with the CPU's")
    return card_launches


def _steady(sim, state):
    """Steady-state s/round of `sim` from `state`: one chunk of 3 rounds of
    warm-up, then SAMPLED_TIMED_CHUNKS chunks of 3, each timed alone."""
    state, _ = sim.run_chunk(state, 3)
    per_round = []
    for _ in range(SAMPLED_TIMED_CHUNKS):
        t0 = time.perf_counter()
        state, _ = sim.run_chunk(state, 3)
        per_round.append((time.perf_counter() - t0) / 3)
    return state, statistics.median(per_round), per_round


def _host_draws(sim, state, n=3, reps=5):
    """Median host seconds a round of a sampled chunk's draws: the cohort
    draw, the M-wide realization and its uplink resolution, and the index
    stack, each on fresh host streams at `state`."""
    from repro_torch.federated.client import stack_cohort_indices
    parts = {"cohorts": [], "realization": [], "indices": []}
    for _ in range(reps):
        iters, stream = sim._materialize(state)
        t0 = time.perf_counter()
        cohorts = stream.draw_cohorts(n)
        t1 = time.perf_counter()
        sim._chunk_uplink(stream.draw_chunk(n))
        t2 = time.perf_counter()
        stack_cohort_indices(iters, cohorts, sim.fed.local_rounds)
        t3 = time.perf_counter()
        for k, dt in zip(parts, (t1 - t0, t2 - t1, t3 - t2)):
            parts[k].append(dt / n)
    return {k: statistics.median(v) for k, v in parts.items()}


def phase_sampled_cost(counters, card, scale, dense):
    """19 (f): steady-state s/round of (b) beside a dense M = K run, the
    host's share of a sampled round, and one profiled round (none a
    gate)."""
    sim, state, _ = scale
    state, s_round, s_runs = _steady(sim, state)
    _, d_round, d_runs = _steady(dense, dense.init())
    print(f"[sampled] (f) steady state on {card}: K = {SAMPLED_K} of M = "
          f"{SAMPLED_M} {s_round!r} s per round, dense M = {SAMPLED_K} "
          f"{d_round!r} (chunks {s_runs!r} and {d_runs!r}); throughput "
          f"ratio {d_round / s_round:.3f} (the reference's CPU gate "
          f">= {SAMPLED_REF_GATE}, not a gate here)", flush=True)
    host = _host_draws(sim, state)
    total = sum(host.values())
    print(f"[sampled] (f) host draws a round: cohorts {host['cohorts']!r} s, "
          f"M-wide realization and uplink {host['realization']!r} s, index "
          f"stack {host['indices']!r} s; {total / s_round:.1%} of the "
          "sampled round", flush=True)
    for ops in counters.values():
        ops.launches = 0
    _, wall, busy, top = profiled(lambda: sim.run(state, max_rounds=3,
                                                  eval_every=3))
    launches = {k: ops.launches for k, ops in counters.items()}
    print(f"[sampled] (f) profiled 3 rounds on {card}: wall {wall:.4f} s, "
          f"device busy {busy:.4f} s ({busy / wall:.1%}; idle "
          f"{1 - busy / wall:.1%}), launches {launches}, profiler on",
          flush=True)
    for kname, sec in top[:6]:
        print(f"[sampled]   {sec / 3 * 1e3:9.3f} ms/round {sec / busy:6.1%}  "
              f"{kname[:90]}")
    print_fold_time("sampled", top, busy, 3)
    return launches


# -- the asynchronous backend (phase 20) -------------------------------------------

# (a), (b), (f), (g): compressed mnist_paper on the event queue under
# 'stragglers', a buffer of ASYNC_K updates an aggregation, polynomial
# staleness weights; (a) runs ASYNC_EVENTS events, then ASYNC_AGGS
# aggregations; (b) stops after ASYNC_MID events (odd: mid-buffer).
ASYNC_K, ASYNC_EVENTS, ASYNC_AGGS, ASYNC_MID = 5, 11, 6, 7
# (g): timed chunks of one aggregation each, after ASYNC_WARM of warm-up.
ASYNC_TIMED_AGGS, ASYNC_WARM = 4, 2


def async_paper_spec(**kw):
    """Compressed mnist_paper on the event queue (phase 20 (a))."""
    from repro_torch.federated.events import AsyncSpec
    return compressed_spec("mnist_paper").replace(
        scenario="stragglers", backend="async",
        async_spec=AsyncSpec(buffer_size=ASYNC_K, staleness="poly"), **kw)


def _watch_chunks(sim):
    """Record every chunk `sim` checks against its twin: a list that
    fills with (the device's pops, the twin's pops, the twin's events)."""
    seen, check = [], sim._async_records

    def watched(ys, evs, n_ev, r0, bits_acc):
        seen.append(([int(c) for c in ys["client"][:n_ev]],
                     [e.client for e in evs], list(evs)))
        return check(ys, evs, n_ev, r0, bits_acc)

    sim._async_records = watched
    return seen


def _host_bits(evs, bits):
    """Each aggregation's uplink bits recomputed on the host from the
    twin's events: one compressed update a kept arrival since the last
    aggregation."""
    out, acc = [], 0.0
    for e in evs:
        acc += 0.0 if e.dropped else bits
        if e.aggregated:
            out.append(acc)
            acc = 0.0
    return out


def phase_async(counters, card):
    """20 (a): compressed mnist_paper on the event queue: run_events, then
    run; one quantize launch an event over one client's rows, the twin's
    pops equal the device's in every chunk, the event clock monotone, the
    uplink bits a host recomputation's, finite losses."""
    from repro_torch.federated import compression
    from repro_torch.utils.tree import leaves
    import torch
    spec = async_paper_spec()
    plan = spec.resolve_plan()
    print(f"[async] (a) mnist_paper on the event queue: scenario "
          f"{spec.scenario}, AsyncSpec(buffer_size={ASYNC_K}, "
          f"staleness='poly'), plan b*={plan.b} V={plan.V}, compressed",
          flush=True)
    sim = _on_card(spec.build(), "async mnist_paper")
    seen = _watch_chunks(sim)
    state = sim.init()
    rows = compression.n_rows(sim.params(state))
    bits = compression.compressed_bits(sim.params(state))

    def drive():
        st, first = sim.run_events(state, ASYNC_EVENTS)
        st, res = sim.run(st, max_rounds=ASYNC_AGGS, eval_every=3)
        return st, first + res.history

    t0 = time.perf_counter()
    ((st, hist), q_rows), launches = _launched(
        counters, lambda: _quantize_rows(drive))
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    evs = [e for _, _, chunk in seen for e in chunk]
    times = [r.sim_time for r in hist]
    pops_ok = all(dev == twin for dev, twin, _ in seen)
    for r in hist:
        print(f"[async] aggregation {r.round}: sim_time={r.sim_time:.6f}s "
              f"train_loss={r.train_loss:.6f} uplink_bits="
              f"{r.uplink_bits:.0f}"
              + (f" test_acc={r.test_acc:.4f}" if r.test_acc is not None
                 else ""))
    print(f"[async] (a) {st.event} events, {len(hist)} aggregations in "
          f"{elapsed:.3f} s (warm-up included), {len(seen)} chunks, device "
          f"pops equal the twin's in every chunk {pops_ok}, launches "
          f"{launches}, quantize rows {sorted(set(q_rows))}", flush=True)
    if not pops_ok or not seen:
        raise SystemExit("the async twin disagrees with the device's pops")
    if (launches["quantize"] != st.event or len(q_rows) != st.event
            or set(q_rows) != {rows}):
        raise SystemExit(f"expected one quantize launch of {rows} rows an "
                         f"event ({st.event}), got {q_rows}")
    others = {k: n for k, n in launches.items()
              if k not in FL_KERNELS and n}
    if others or not launches["fold_matmul"]:
        raise SystemExit(f"the async path launched other kernels, or not "
                         f"the fold matmul: {launches}")
    if times != sorted(times) or len(hist) < ASYNC_AGGS:
        raise SystemExit(f"the event clock is not monotone: {times}")
    if [r.uplink_bits for r in hist] != _host_bits(evs, bits):
        raise SystemExit("the async records' uplink bits differ from the "
                         "host's recomputation")
    if not all(math.isfinite(r.train_loss) for r in hist) or not all(
            bool(torch.isfinite(p).all()) for p in leaves(sim.params(st))):
        raise SystemExit("non-finite loss or params on the async path")
    return launches, (sim, st)


def phase_async_checkpoint(counters):
    """20 (b): ASYNC_MID events (mid-buffer), save_state, load_state into
    a fresh simulator and on to 4 aggregations: params, carry and records
    bit for bit against 4 aggregations alone."""
    import tempfile
    from repro_torch.federated.simulation import load_state, save_state
    spec = async_paper_spec()

    def both():
        whole = spec.build()
        w_st, w_res = whole.run(whole.init(3), max_rounds=4)
        first = spec.build()
        mid, head = first.run_events(first.init(3), ASYNC_MID)
        with tempfile.TemporaryDirectory() as tmp:
            path = str(Path(tmp) / "async.pkl")
            save_state(path, mid)
            fresh = spec.build()
            restored = load_state(path, like=fresh.init())
        end, tail = fresh.run(restored, max_rounds=4 - len(head))
        return (whole, w_st, w_res.history), (fresh, end,
                                              head + tail.history), mid

    (a, b, mid), launches = _launched(counters, both)
    # run_events evaluates nothing, so test_acc is left out.
    fields = RECORD_FIELDS + ("train_loss",)
    same = (_params_same((a[0].params(a[1]), a[1].async_c),
                         (b[0].params(b[1]), b[1].async_c))
            and [[getattr(r, f) for f in fields] for r in a[2]]
            == [[getattr(r, f) for f in fields] for r in b[2]])
    print(f"[async] (b) {ASYNC_MID} events ({int(mid.async_c['cnt'])} "
          f"updates in the buffer), save_state, load_state into a fresh "
          f"simulator, on to 4 aggregations: params, carry and records bit "
          f"for bit against 4 aggregations alone {same}; launches "
          f"{launches}", flush=True)
    if not same or int(mid.async_c["cnt"]) == 0:
        raise SystemExit("the mid-buffer checkpoint does not resume bit for "
                         "bit")
    return launches


def phase_async_sync_limit(counters):
    """20 (c): uncompressed mnist_paper under 'uniform', AsyncSpec(
    buffer_size=M, staleness='constant'): 3 aggregations against 3 scan
    rounds, losses within 1e-5 relative and params within 5e-4."""
    from repro_torch.federated import experiment
    from repro_torch.federated.events import AsyncSpec
    base = experiment.get("mnist_paper").replace(scenario="uniform")
    M = base.fed.n_devices
    a_spec = base.replace(backend="async", async_spec=AsyncSpec(
        buffer_size=M, staleness="constant"))
    out = {}
    for name, spec in (("async", a_spec), ("scan", base)):
        sim = _on_card(spec.build(), f"sync-limit {name}")
        (_, out[name]), launches = _launched(counters, lambda: sim.run(
            sim.init(), max_rounds=3, eval_every=3))
        _check_uncompressed(f"async-sync-limit {name}", launches)
    a, s = out["async"], out["scan"]
    loss = max(abs(x.train_loss - y.train_loss) / abs(y.train_loss)
               for x, y in zip(a.history, s.history))
    param = _params_gap(a.params, s.params)
    bits = _params_same(a.params, s.params)
    print(f"[async] (c) sync limit (K = M = {M}, constant, uniform, "
          f"uncompressed): 3 aggregations against 3 scan rounds: max rel "
          f"loss gap {loss:.3g} (tol {FLEET_LOSS_RTOL:g}), params gap "
          f"{param:.3g} (tol {FLEET_PARAM_ATOL:g}), bit for bit {bits}; "
          f"participants {[r.n_participants for r in a.history]}; event "
          f"clock {[r.sim_time for r in a.history]} against Eq. 8's "
          f"{[r.sim_time for r in s.history]}", flush=True)
    if loss > FLEET_LOSS_RTOL or param > FLEET_PARAM_ATOL:
        raise SystemExit("the async sync limit breaks its bounds against "
                         "scan")
    return launches


def phase_async_reference(counters):
    """20 (d): compressed mnist_async on the card and on the CPU from the
    same model and quantizer noise: records exact, losses and params
    within phase 5's bounds."""
    runs, launches = _card_and_cpu(counters, compressed_spec("mnist_async"),
                                   4, 2)
    exact, loss, param, same = _gaps(runs["cuda"][1], runs["cpu"][1])
    print(f"[async] (d) mnist_async cuda vs cpu, 4 aggregations: records "
          f"exact {exact}, max rel loss gap {loss:.2e}, max param gap "
          f"{param:.2e}, bit for bit {same}; card launches {launches}",
          flush=True)
    if not exact or loss > 1e-5 or param > 5e-4:
        raise SystemExit("the card's async run disagrees with the CPU's")
    return launches


def phase_async_fedasync(counters):
    """20 (e): fedasync (K = 1, server_lr 0.5) runs and differs from
    fedbuff at K = 1."""
    from repro_torch.federated import experiment
    from repro_torch.federated.events import AsyncSpec
    base = experiment.get("mnist_async")
    res, fl_launches = {}, []
    for mode, lr in (("fedbuff", 1.0), ("fedasync", 0.5)):
        sim = base.replace(async_spec=AsyncSpec(
            buffer_size=1, mode=mode, server_lr=lr)).build()
        (_, res[mode]), launches = _launched(counters, lambda: sim.run(
            sim.init(), max_rounds=4, eval_every=4))
        _check_uncompressed(f"async {mode}", launches)
        fl_launches.append(launches)
    gap = _params_gap(res["fedbuff"].params, res["fedasync"].params)
    finite = all(math.isfinite(r.train_loss) for m in res.values()
                 for r in m.history)
    print(f"[async] (e) fedasync (K=1, server_lr 0.5) against fedbuff "
          f"(K=1), 4 aggregations each: params gap {gap:.3g}, losses "
          f"finite {finite}", flush=True)
    if not gap > 0 or not finite:
        raise SystemExit("fedasync does not differ from fedbuff, or is not "
                         "finite")
    return fl_launches


def phase_async_no_sync(paper_async):
    """20 (f): one chunk's events under torch.cuda.set_sync_debug_mode(
    'error'): the inputs go up before it and its one fetch comes after."""
    import torch
    from repro_torch.federated.simulation import fetch_columns
    sim, state = paper_async
    state, mat, gen, twin, _ = sim._async_begin(state)
    xs, evs, n = sim._async_chunk_inputs(mat[0], twin, mat[1],
                                         stop_events=2 * ASYNC_K)
    inputs = {"t_svc": torch.from_numpy(xs["t_svc"]).cuda(),
              "drop_next": torch.from_numpy(xs["drop_next"]).cuda(),
              "idx": torch.from_numpy(xs["idx"]).long().cuda()}
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = sim._chunk_fn(state.params_C, state.opt_C, gen, state.async_c,
                            sim._sizes, sim._data_dev, inputs)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    ys = fetch_columns(out[3])
    ok = list(ys["client"].astype(int)) == [e.client for e in evs]
    print(f"[async] (f) {n} events of one chunk under "
          f"set_sync_debug_mode('error'): no host synchronisation inside; "
          f"its one fetch's pops equal the twin's {ok}", flush=True)
    if not ok:
        raise SystemExit("the no-sync chunk's pops differ from the twin's")


def phase_async_cost(counters, card, paper):
    """20 (g): steady-state s/event and s/aggregation of (a)'s spec beside
    scan's s/round of the same spec, the host's draws an event, a
    profiled window of 2 aggregations, and the async-vs-sync example
    twin's quick table (none a gate)."""
    import torch
    spec = async_paper_spec(with_eval=False)
    sim = _on_card(spec.build(), "async cost")
    state, _ = sim.run(sim.init(), max_rounds=ASYNC_WARM)
    spans, n_ev = [], []
    for _ in range(ASYNC_TIMED_AGGS):
        e0 = state.event
        t0 = time.perf_counter()
        state, _ = sim.run(state, max_rounds=1)
        spans.append(time.perf_counter() - t0)
        n_ev.append(state.event - e0)
    scan = _on_card(spec.replace(backend="scan", async_spec=None).build(),
                    "scan cost")
    _, s_round, s_runs = _steady(scan, scan.init())
    print(f"[async] (g) steady state on {card}: {sum(spans) / sum(n_ev)!r} "
          f"s per event, {statistics.median(spans)!r} s per aggregation "
          f"(median of {ASYNC_TIMED_AGGS}: {spans!r}, events {n_ev}, no "
          f"eval); scan {s_round!r} s per round of the same spec (chunks "
          f"{s_runs!r}; phase 4's scenario-less mnist_paper "
          f"{paper['s_per_round']!r})", flush=True)
    host = []
    for _ in range(5):
        _, mat, _, twin, _ = sim._async_begin(state)
        t0 = time.perf_counter()
        _, _, n = sim._async_chunk_inputs(mat[0], twin, mat[1], stop_aggs=1)
        host.append((time.perf_counter() - t0) / n)
    print(f"[async] (g) the host's draws an event (twin step, M-wide "
          f"dispatch draw, the client's batch indices): "
          f"{statistics.median(host)!r} s, "
          f"{statistics.median(host) * sum(n_ev) / sum(spans):.1%} of an "
          "event", flush=True)
    for ops in counters.values():
        ops.launches = 0
    (end, _), wall, busy, top = profiled(lambda: sim.run(state, max_rounds=2))
    launches = {k: ops.launches for k, ops in counters.items()}
    events = end.event - state.event
    print(f"[async] (g) profiled 2 aggregations ({events} events) on {card}: "
          f"wall {wall:.4f} s, device busy {busy:.4f} s ({busy / wall:.1%}; "
          f"idle {1 - busy / wall:.1%}), launches {launches}, profiler on",
          flush=True)
    for kname, sec in top[:6]:
        print(f"[async]   {sec / events * 1e3:9.3f} ms/event {sec / busy:6.1%}"
              f"  {kname[:90]}")
    fold = sum(s for kname, s in top if "::fold_" in kname)
    quant = sum(s for kname, s in top if "quantize_rows" in kname)
    print(f"[async]   fold matmul {fold / events * 1e3:.3f} ms/event "
          f"({fold / busy:.1%}), quantize {quant / events * 1e3:.4f} "
          f"ms/event ({quant / busy:.1%})", flush=True)
    example = _load_example("async_vs_sync_torch")
    t0 = time.perf_counter()
    _, ex_launches = _launched(counters, lambda: example.main(
        ["--quick", "--scenario", "stragglers"]))
    torch.cuda.synchronize()
    print(f"[async] (g) examples/async_vs_sync_torch.py --quick --scenario "
          f"stragglers on the card: {time.perf_counter() - t0:.2f} s, "
          f"launches {ex_launches}", flush=True)
    return [launches, ex_launches]


# -- trace-driven fleets and the online planner (phase 21) -------------------------

# (a), (b), (f): compressed mnist_diurnal at the paper CNN's full width;
# (c): a recorded diurnal_edge trace of TRACE_RECORD rounds replayed under
# it, and a 2-arm Study on that replay of TRACE_STUDY_ROUNDS rounds.
TRACE_ROUNDS, TRACE_RECORD, TRACE_STUDY_ROUNDS = 6, 8, 3


def diurnal_spec(**kw):
    """Compressed mnist_diurnal at full width (phase 21 (a))."""
    return compressed_spec("mnist_diurnal").replace(
        model="mnist_cnn", n_train=1500, n_test=400, with_eval=False, **kw)


def _trace_twin(sim, rounds):
    """Per-round (participants, sim_time, uplink bits) of `sim`'s first
    `rounds` rounds from init(), recomputed on the host from its
    scenario's own stream (draw_chunk) on the same population and seed,
    with the delay model's Eq. 6 and Eq. 8."""
    from repro_torch.core import delay
    from repro_torch.federated import compression, scenarios
    scen = scenarios.get(sim.scenario)
    chunk = scen.stream(sim.pop, seed=sim.fed.seed).draw_chunk(rounds)
    bits = float(compression.compressed_bits(sim.params(sim.init())))
    t_cp = delay.per_client_compute_time(sim.fed.batch_size, sim.pop.G,
                                         sim.pop.f)
    t_cm = delay.per_client_uplink_time(bits, sim.wireless, sim.pop.p,
                                        chunk.h)
    T_cm, T_cp = delay.chunk_round_times(t_cp, t_cm, chunk.clock_mask)
    out, t = [], 0.0
    for r in range(rounds):
        t += delay.round_time(float(T_cm[r]), float(T_cp[r]),
                              sim.fed.local_rounds)
        n = int(chunk.mask[r].sum())
        out.append((n, t, n * bits))
    return out


def _participation(hist):
    return [(r.n_participants, r.sim_time, r.uplink_bits) for r in hist]


def phase_trace(counters, card):
    """21 (a): compressed mnist_diurnal at full width, 6 rounds in two
    chunks: one quantize launch a round over M x rows, the fold matmul, no
    other kernel; participants, clock and bits equal to the host's
    recomputation from the trace stream; presence gated in some round;
    finite losses."""
    import torch
    from repro_torch.federated import compression
    from repro_torch.utils.tree import leaves
    spec = diurnal_spec()
    plan = spec.resolve_plan()
    sim = _on_card(spec.build(), "trace-driven mnist_diurnal")
    M = sim.fed.n_devices
    rows = M * compression.n_rows(sim.params(sim.init()))
    print(f"[trace] (a) mnist_diurnal at full width: {spec.model}, scenario "
          f"{spec.scenario} (phone/tablet/IoT classes, diurnal waves, "
          f"battery and thermal gates), M={M}, plan b*={plan.b} V={plan.V}, "
          f"compressed", flush=True)
    t0 = time.perf_counter()
    ((state, res), q_rows), launches = _launched(
        counters, lambda: _quantize_rows(lambda: sim.run(
            sim.init(), max_rounds=TRACE_ROUNDS, eval_every=3)))
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    hist = res.history
    for r in hist:
        print(f"[trace] round {r.round}: participants {r.n_participants}/{M} "
              f"sim_time={r.sim_time!r}s train_loss={r.train_loss:.6f} "
              f"uplink_bits={r.uplink_bits:.0f}")
    twin = _trace_twin(sim, TRACE_ROUNDS)
    same = _participation(hist) == twin
    print(f"[trace] (a) {len(hist)} rounds in {elapsed:.3f} s on {card} "
          f"(warm-up included), launches {launches}, quantize rows "
          f"{q_rows}; participants, clock and bits equal to the host's "
          f"recomputation from draw_chunk {same}", flush=True)
    _check_quantize_rounds("trace", launches, len(hist))
    if q_rows != [rows] * len(hist) or len(hist) != TRACE_ROUNDS:
        raise SystemExit(f"[trace] expected {TRACE_ROUNDS} quantize launches "
                         f"of {rows} rows, got {q_rows}")
    others = {k: n for k, n in launches.items() if k not in FL_KERNELS and n}
    if others or not launches["fold_matmul"]:
        raise SystemExit(f"[trace] the trace path launched other kernels, "
                         f"or not the fold matmul: {launches}")
    if not same:
        raise SystemExit(f"[trace] the records differ from the host's "
                         f"recomputation: {_participation(hist)} vs {twin}")
    if min(r.n_participants for r in hist) >= M:
        raise SystemExit("[trace] the trace gated no client in 6 rounds")
    if not all(math.isfinite(r.train_loss) for r in hist) or not all(
            bool(torch.isfinite(p).all()) for p in leaves(res.params)):
        raise SystemExit("[trace] non-finite loss or params")
    return launches, (sim, state, res)


def phase_trace_checkpoint(counters, straight):
    """21 (b): 3 rounds, save_state, load_state into a fresh simulator, 3
    more: records, params and the trace's stream snapshot bit for bit
    against (a)'s 6 rounds straight."""
    import tempfile
    from repro_torch.federated.simulation import load_state, save_state
    sim, end, whole = straight
    spec = diurnal_spec()

    def resume():
        mid, head = sim.run(sim.init(), max_rounds=3)
        with tempfile.TemporaryDirectory() as tmp:
            path = str(Path(tmp) / "trace.pkl")
            save_state(path, mid)
            fresh = _on_card(spec.build(), "resumed mnist_diurnal")
            restored = load_state(path, like=fresh.init())
        st, tail = fresh.run(restored, max_rounds=3)
        return st, head.history + tail.history, mid.stream

    (st, hist, mid_stream), launches = _launched(counters, resume)
    fields = RECORD_FIELDS + ("train_loss",)
    same = (_params_same(whole.params, sim.params(st))
            and [[getattr(r, f) for f in fields] for r in hist]
            == [[getattr(r, f) for f in fields] for r in whole.history]
            and pickle.dumps(st.stream) == pickle.dumps(end.stream))
    print(f"[trace] (b) 3 rounds, save_state (trace tick "
          f"{mid_stream['trace']['tick']}), load_state into a fresh "
          f"simulator, 3 more: records, params and the stream's snapshot "
          f"bit for bit against 6 straight {same}; launches {launches}",
          flush=True)
    _check_quantize_rounds("trace-resume", launches, 6)
    if not same:
        raise SystemExit("[trace] the checkpoint does not resume bit for bit")
    return launches


def phase_trace_replay(counters, card):
    """21 (c): record_trace('diurnal_edge', M, 8) into a temporary
    directory, the full-width spec replaying it (scenario=None, trace=
    TraceSpec(path)): 6 rounds whose participants are the recorded
    present-minus-lost counts; then a 2-arm Study on that spec (the DEFL
    plan and FedAvg at Fig. 2's fixed b = 10, V = 20) that forms one
    group, each member against its run alone over 3 rounds (records exact,
    loss within 1e-5 relative, params within 5e-4)."""
    import tempfile
    from repro_torch.configs.base import FedConfig
    from repro_torch.federated.study import Study
    from repro_torch.federated.traces import TraceSpec, record_trace
    base = diurnal_spec()
    M = base.fed.n_devices
    out = []
    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "diurnal.jsonl")
        record_trace("diurnal_edge", M, TRACE_RECORD, path, seed=5)
        with open(path) as fh:
            recs = [json.loads(line) for line in fh][1:]
        want = [len(set(r["present"]) - set(r.get("lost", ())))
                for r in recs][:TRACE_ROUNDS]
        spec = base.replace(scenario=None, trace=TraceSpec(path))
        sim = _on_card(spec.build(), "replayed trace")
        (_, res), launches = _launched(counters, lambda: sim.run(
            sim.init(), max_rounds=TRACE_ROUNDS, eval_every=3))
        got = [r.n_participants for r in res.history]
        print(f"[trace] (c) record_trace('diurnal_edge', {M}, {TRACE_RECORD})"
              f" replayed at full width ({spec.scenario_ref().name}): "
              f"participants {got}, recorded present-minus-lost {want}, "
              f"launches {launches}", flush=True)
        _check_quantize_rounds("trace-replay", launches, TRACE_ROUNDS)
        if got != want:
            raise SystemExit("[trace] the replay's participants differ from "
                             "the recorded arrivals")
        out.append(launches)
        fedavg = FedConfig(n_devices=M, batch_size=10,
                           theta=float(math.exp(-20 / 2.0)), nu=2.0, lr=0.05,
                           compress_updates=True)
        study = Study(arms=[("DEFL", spec),
                            ("FedAvg", spec.replace(plan=False, fed=fedavg))],
                      seeds=(0,), max_rounds=TRACE_STUDY_ROUNDS)
        sims = {label: _on_card(s, f"trace study arm {label}")
                for label, s in study.build_sims().items()}
        res, launches = _launched(counters, lambda: study.run(sims=sims))
        print(f"[trace] (c) 2-arm Study on the replay on {card}: groups "
              f"{res.groups}, launches {launches}", flush=True)
        if res.groups != (("DEFL", "FedAvg"),):
            raise SystemExit("[trace] the arms on one trace did not form one "
                             "group")
        _check_quantize_rounds("trace-study", launches, TRACE_STUDY_ROUNDS)
        out.append(launches)
        for label, s in sims.items():
            (_, alone), n = _launched(counters, lambda: s.run(
                s.init(0), max_rounds=TRACE_STUDY_ROUNDS))
            out.append(n)
            exact, loss, param, same = _gaps(res[label][0], alone)
            print(f"[trace] (c) {label} b={s.fed.batch_size} "
                  f"V={s.fed.local_rounds}: member vs alone over "
                  f"{TRACE_STUDY_ROUNDS} rounds: records exact {exact}, "
                  f"loss gap {loss:.3g}, params gap {param:.3g}, "
                  f"bit-identical {same}", flush=True)
            if not exact or loss > FLEET_LOSS_RTOL or param > FLEET_PARAM_ATOL:
                raise SystemExit(f"[trace] study member {label} breaks the "
                                 "member contract against its run alone")
    return out


def phase_trace_reference(counters):
    """21 (d): compressed mnist_diurnal at its registered size on the card
    and on the CPU from the same model and quantizer noise: records exact,
    losses and params within phase 5's bounds."""
    runs, launches = _card_and_cpu(counters, compressed_spec("mnist_diurnal"),
                                   4, 2)
    card_res = runs["cuda"][1]
    exact, loss, param, same = _gaps(card_res, runs["cpu"][1])
    print(f"[trace] (d) mnist_diurnal cuda vs cpu, 4 rounds: participants "
          f"{[r.n_participants for r in card_res.history]}, records exact "
          f"{exact}, max rel loss gap {loss:.2e}, max param gap {param:.2e}, "
          f"bit for bit {same}; card launches {launches}", flush=True)
    if not exact or loss > 1e-5 or param > 5e-4:
        raise SystemExit("the card's trace-driven run disagrees with the "
                         "CPU's")
    _check_quantize_rounds("trace-reference", launches, 4)
    return launches


def phase_planner_demo():
    """21 (e): the planner demo twin, --quick --check, with its table (the
    planner is numpy on the host: no kernel launches)."""
    example = _load_example("planner_service_demo_torch")
    t0 = time.perf_counter()
    example.main(["--quick", "--check"])
    print(f"[trace] (e) examples/planner_service_demo_torch.py --quick "
          f"--check: {time.perf_counter() - t0:.2f} s on the host", flush=True)


def phase_trace_cost(counters, card, paper, straight):
    """21 (f): steady-state s/round of (a)'s spec beside phase 4's
    mnist_paper, the host's trace draws a chunk (TraceStream.draw_chunk)
    and a profiled window of 3 rounds (none a gate)."""
    sim, state, _ = straight
    state, s_round, runs = _steady(sim, state)
    print(f"[trace] (f) steady state on {card}: {s_round!r} s per round "
          f"(median of {len(runs)} chunks of 3, no eval: {runs!r}); phase "
          f"4's mnist_paper {paper['s_per_round']!r}", flush=True)
    from repro_torch.federated import scenarios
    scen = scenarios.get(sim.scenario)
    draws = []
    for _ in range(7):
        stream = scen.stream(sim.pop, seed=sim.fed.seed)
        t0 = time.perf_counter()
        stream.draw_chunk(3)
        draws.append(time.perf_counter() - t0)
    print(f"[trace] (f) the host's trace draws a chunk of 3 rounds "
          f"(TraceStream.draw_chunk, M={sim.fed.n_devices}): median "
          f"{statistics.median(draws)!r} s ({statistics.median(draws) / 3 / s_round:.2%} "
          f"of a round)", flush=True)
    for ops in counters.values():
        ops.launches = 0
    _, wall, busy, top = profiled(lambda: sim.run(state, max_rounds=3))
    launches = {k: ops.launches for k, ops in counters.items()}
    print(f"[trace] (f) profiled 3 rounds on {card}: wall {wall:.4f} s, "
          f"device busy {busy:.4f} s ({busy / wall:.1%}; idle "
          f"{1 - busy / wall:.1%}), launches {launches}, profiler on",
          flush=True)
    for kname, sec in top[:6]:
        print(f"[trace]   {sec / 3 * 1e3:9.3f} ms/round {sec / busy:6.1%}  "
              f"{kname[:90]}")
    quant = sum(sec for kname, sec in top if "quantize_rows" in kname)
    print(f"[trace]   quantize kernel: {quant / 3 * 1e3:.4f} ms/round, "
          f"{quant / busy:.1%} of device time", flush=True)
    print_fold_time("trace", top, busy, 3)
    return launches


# -- the Study: DEFL vs FedAvg vs Rand (phase 17) ------------------------------------

# (a): the twin's Fig. 2 comparison, one scenario, FIG2_SEEDS seeds, up to
# FIG2_ROUNDS rounds (the twin's full run; the members stop at its 90%
# target accuracy).
FIG2_SCENARIO = "uniform"
FIG2_SEEDS = 2
FIG2_ROUNDS = 12
# (b): rounds of the compressed MNIST group, and of its per-round member
# contract from equal states; (d): rounds in each timed window.
STUDY_ROUNDS = 4
STUDY_TIMED_ROUNDS = 3


def _load_example(name):
    import importlib.util
    path = Path(__file__).resolve().parent / "examples" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _stop_explained(short, long, target):
    """A target_acc stop that falls on another round: the shorter run
    stopped at an eval that reached `target` where the longer run's eval
    of the same round did not (test_acc follows the params, which the
    member contract holds to a bound, not to the bit)."""
    if not short.history:
        return False
    last = short.history[-1]
    other = long.history[len(short.history) - 1]
    return (last.test_acc is not None and last.test_acc >= target
            and other.test_acc is not None and other.test_acc < target)


def _member_vs_alone(tag, label, seed, got, alone, target):
    """Gate a study member against its simulator's run alone: the records
    exact where both ran, and the same number of rounds unless a
    target_acc stop straddles the target between them."""
    a, b = _records(got), _records(alone)
    n = min(len(a), len(b))
    exact = a[:n] == b[:n]
    same_rounds = len(a) == len(b)
    note = ""
    if not same_rounds:
        short, long = (got, alone) if len(a) < len(b) else (alone, got)
        if not _stop_explained(short, long, target):
            raise SystemExit(
                f"[{tag}] {label} seed {seed}: {len(a)} rounds in the study, "
                f"{len(b)} alone, not explained by a target_acc stop")
        note = (f" (rounds {len(a)} vs {len(b)}: test_acc "
                f"{short.history[-1].test_acc} vs "
                f"{long.history[len(short.history) - 1].test_acc} at round "
                f"{len(short.history)} across the target {target})")
    print(f"[{tag}] {label} seed {seed}: b={got.fed.batch_size} "
          f"V={got.fed.local_rounds} rounds {len(a)} (alone {len(b)}), "
          f"records exact {exact}, final acc {got.history[-1].test_acc} "
          f"(alone {alone.history[-1].test_acc}){note}", flush=True)
    if not exact:
        raise SystemExit(f"[{tag}] {label} seed {seed}: clock, bits or "
                         "participants differ from its run alone")
    return same_rounds


def _check_plans(tag, study, sims):
    """Each arm's simulator runs its own analytic plan: the DEFL arm the
    solved (b*, V) (b* capped at the spec's batch_cap), the baselines their
    fixed (b, V)."""
    plans = study.plans()
    for label, spec in study.arms:
        plan, fed = plans[label], sims[label].fed
        b = (min(plan.b, spec.batch_cap) if spec.plan and spec.batch_cap
             else plan.b)
        print(f"[{tag}] {label}: plan b={plan.b} V={plan.V} "
              f"theta={plan.theta:.6f} T_round={plan.T_round:.6f}s "
              f"overall_pred={plan.overall_pred:.4f}s; runs b={fed.batch_size}"
              f" V={fed.local_rounds}", flush=True)
        if (fed.batch_size, fed.local_rounds) != (b, plan.V) or \
                dataclasses.asdict(fed) != dataclasses.asdict(
                    spec.resolve_fed()):
            raise SystemExit(f"[{tag}] arm {label} does not run its plan")


def _padding_share(sims):
    """The share of a group's local-step work (sample-steps: V_env x B_env
    a client of each member) that is padding."""
    V_env = max(s.fed.local_rounds for s in sims)
    B_env = max(s.fed.batch_size for s in sims)
    real = sum(s.fed.local_rounds * s.fed.batch_size for s in sims)
    return 1.0 - real / (len(sims) * V_env * B_env), (V_env, B_env)


def phase_fig2(counters, card):
    """(a): the twin's Fig. 2 study at full width on MNIST and CIFAR, each
    member against its own run alone."""
    import torch
    twin = _load_example("defl_vs_fedavg_torch")
    print(twin.HEADER, flush=True)
    out, all_launches = {}, []
    for ds in ("mnist", "cifar"):
        tag = f"fig2-{ds}"
        study = twin.study_for(ds, FIG2_SCENARIO, seed=0,
                               seeds=FIG2_SEEDS).replace(
                                   max_rounds=FIG2_ROUNDS)
        sims = study.build_sims()
        if any(sim.device.type != "cuda" for sim in sims.values()):
            raise SystemExit(f"[{tag}] the study was built off the card")
        _check_plans(tag, study, sims)
        members = [sims[label] for label, _ in study.arms
                   for _ in study.seeds]
        share, env = _padding_share(members)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res, launches = _launched(counters, lambda: study.run(sims=sims))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        for row in twin.rows_for(res, FIG2_SCENARIO, ds, len(study.seeds) > 1):
            print(",".join(map(str, row)), flush=True)
        rounds = max(r.rounds for label in res.labels for r in res[label])
        print(f"[{tag}] Study of {len(study.arms)} arms x {len(study.seeds)} "
              f"seeds on {card}: groups {res.groups}, envelope (V_env, B_env) "
              f"= {env}, {len(members)} members x "
              f"{sims['DEFL'].fed.n_devices} clients, {rounds} rounds in "
              f"{wall:.2f} s (eval every round, warm-up included), padding "
              f"{share:.1%} of the local-step work, launches {launches}",
              flush=True)
        if res.groups != (tuple(label for label, _ in study.arms),):
            raise SystemExit(f"[{tag}] the arms did not form one group")
        _check_uncompressed(tag, launches)
        all_launches.append(launches)
        for label, _ in study.arms:
            sim = sims[label]
            for i, seed in enumerate(study.seeds):
                got = res[label][i]
                if not all(math.isfinite(r.train_loss) for r in got.history):
                    raise SystemExit(f"[{tag}] non-finite loss: {label}")
                _, alone = sim.run(sim.init(seed), max_rounds=FIG2_ROUNDS,
                                   eval_every=1, target_acc=study.target_acc)
                _member_vs_alone(tag, label, seed, got, alone,
                                 study.target_acc)
        out[ds] = (study, sims, share, env)
    return out, all_launches


def _compressed_arms(study):
    return study.replace(arms=[
        (label, spec.replace(fed=dataclasses.replace(
            spec.fed, compress_updates=True)))
        for label, spec in study.arms])


def _swapped_env_chunk(inner, C, a, b):
    """The group chunk `inner` with the device envelope masks of the
    members at stack positions a and b swapped: a planted misalignment,
    member a running member b's sample mask, b and V count, and b running
    a's. The step schedule (host rows) stays the stack's."""
    from repro_torch.federated import study as study_mod

    def chunk(params, opt_state, gens, weights, data, idx, mask=None,
              env=None):
        order = list(range(env["v_mask"].shape[0] // C))
        order[a], order[b] = order[b], order[a]
        rows = [r for m in order for r in range(m * C, (m + 1) * C)]
        return inner(params, opt_state, gens, weights, data, idx, mask,
                     {k: v if k in study_mod._HOST_ENV else v[rows]
                      for k, v in env.items()})

    return chunk


def phase_study_compressed(counters, card, study):
    """(b): the MNIST arms with int8 compression: one quantize launch a
    round for the whole group, and each round of every member, from equal
    states, against the same round alone: the records exact, the loss
    within 1e-5 relative and the params within 5e-4 (Study.run's member
    contract), for every member-round of every arm; whether it is also
    bit-identical is printed. Then a planted control: the same group round
    with two members' envelope masks swapped must break the contract."""
    from repro_torch.federated import compression
    from repro_torch.federated import study as study_mod
    tag = "study-int8"
    study = _compressed_arms(study).replace(max_rounds=STUDY_ROUNDS,
                                            target_acc=None)
    sims = study.build_sims()
    _check_plans(tag, study, sims)
    res, launches = _launched(counters, lambda: study.run(sims=sims))
    rounds = max(r.rounds for label in res.labels for r in res[label])
    n_members = len(study.arms) * len(study.seeds)
    print(f"[{tag}] compressed MNIST study, {n_members} members, {rounds} "
          f"rounds on {card}: launches {launches}", flush=True)
    _check_quantize_rounds(tag, launches, rounds)
    for label, _ in study.arms:
        for i, seed in enumerate(study.seeds):
            _, alone = sims[label].run(sims[label].init(seed),
                                       max_rounds=STUDY_ROUNDS)
            _member_vs_alone(tag, label, seed, res[label][i], alone, None)
    # The member contract, round by round from equal states.
    members = [(label, seed) for label, _ in study.arms
               for seed in study.seeds]
    states = {m: sims[m[0]].init(m[1]) for m in members}
    held = {label: 0 for label, _ in study.arms}
    identical = {label: 0 for label, _ in study.arms}
    worst = [0.0, 0.0]
    for r in range(STUDY_ROUNDS):
        group = [study_mod._Member(arm=a, label=label, sim=sims[label],
                                   seed=seed, state=states[label, seed])
                 for a, (label, seed) in enumerate(members)]
        step, n = _launched(counters, lambda: study_mod._run_group(
            group, 1, 1, None, None))
        _check_quantize_rounds(tag, n, 1)
        for (label, seed), (st, got) in zip(members, step):
            _, alone = sims[label].run(states[label, seed], max_rounds=1)
            exact, loss, param, same = _gaps(got, alone)
            worst = [max(worst[0], loss), max(worst[1], param)]
            print(f"[{tag}] round {r + 1} {label} seed {seed}: member vs "
                  f"alone loss {loss:.3g} params {param:.3g}, bit-identical "
                  f"{same}", flush=True)
            if not exact:
                raise SystemExit(f"[{tag}] round {r + 1} of {label} seed "
                                 f"{seed}: records differ from the round "
                                 "alone")
            if loss > FLEET_LOSS_RTOL or param > FLEET_PARAM_ATOL:
                raise SystemExit(
                    f"[{tag}] round {r + 1} of {label} seed {seed} breaks "
                    f"the member contract: loss gap {loss:.3g}, param gap "
                    f"{param:.3g} (tol {FLEET_LOSS_RTOL:g} / "
                    f"{FLEET_PARAM_ATOL:g})")
            held[label] += 1
            identical[label] += same
            states[label, seed] = st
    print(f"[{tag}] member contract, {STUDY_ROUNDS} rounds from equal "
          f"states: member-rounds held at {FLEET_LOSS_RTOL:g} / "
          f"{FLEET_PARAM_ATOL:g} {held} (of {STUDY_ROUNDS * len(study.seeds)} "
          f"an arm), bit-identical {identical}; largest gaps loss "
          f"{worst[0]:.3g} params {worst[1]:.3g}", flush=True)
    # The planted control: in round 1, FedAvg's first member runs Rand's
    # masks and Rand's runs FedAvg's.
    a = members.index(("FedAvg", study.seeds[0]))
    b = members.index(("Rand", study.seeds[0]))
    group = [study_mod._Member(arm=k, label=label, sim=sims[label],
                               seed=seed)
             for k, (label, seed) in enumerate(members)]
    rep = group[0].sim
    build = rep.build_chunk
    stack = study_mod._stack_order(group)
    rep.build_chunk = lambda envelope=False: _swapped_env_chunk(
        build(envelope=envelope), rep.fed.n_devices, stack.index(a),
        stack.index(b))
    try:
        swapped = study_mod._run_group(group, 1, 1, None, None)
    finally:
        del rep.build_chunk  # the class's method again
    for k in (a, b):
        label, seed = members[k]
        _, alone = sims[label].run(sims[label].init(seed), max_rounds=1)
        planted = swapped[k][1].history[0].train_loss
        gap = abs(planted - alone.history[0].train_loss) / abs(
            alone.history[0].train_loss)
        print(f"[{tag}] planted control, {label} seed {seed} run with the "
              f"other arm's envelope masks: round-1 loss {planted:.6g} vs "
              f"alone {alone.history[0].train_loss:.6g}, gap {gap:.3g} "
              f"(contract {FLEET_LOSS_RTOL:g})", flush=True)
        if not gap > FLEET_LOSS_RTOL:
            raise SystemExit(f"[{tag}] the contract's loss bound does not "
                             "catch a member run with another's masks")
    sim = sims[study.arms[0][0]]
    rows = n_members * sim.fed.n_devices * compression.n_rows(
        sim.params(sim.init()))
    return launches, rows


def phase_study_quantize(dev, card, rows):
    """The quantize kernel at the compressed group's row count (all its
    members' clients in one launch): exact against its plain version,
    timed beside it and its bound."""
    import torch
    from repro_torch.kernels.quantize import ops, ref
    g = torch.Generator().manual_seed(17)
    x = (torch.randn(rows, 1024, generator=g) * 1e-3).to(dev)
    u = ref.stochastic_noise(torch.Generator(device=dev).manual_seed(3),
                             x.shape)
    q, sc = ops.quantize(x, u)
    q_r, s_r = ref.quantize_ref(x, u)
    bad = int((q != q_r).sum()) + int((sc != s_r).sum())
    ms = time_ms(lambda: ops.quantize(x, u))
    plain_ms = time_ms(lambda: ref.quantize_ref(x, u))
    n_bytes = rows * 1024 * (4 + 4 + 1) + rows * 4
    bound_ms, bound_by = bound(n_bytes, 7 * rows * 1024, FP32_OPS_PER_S)
    print(f"[study-int8] quantize {rows}x1024 (the group's launch) on {card}: "
          f"{bad} mismatches, kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"bound {bound_ms:.4f} ms ({bound_by}: {n_bytes / 1e6:.1f} MB), "
          f"{bound_ms / ms:.1%} of bound", flush=True)
    if bad:
        raise SystemExit("quantize kernel disagrees at the study's rows")


def phase_bit_check(counters, card, study, sims):
    """(c): Study(bit_check=True) on the Fig. 2 MNIST group itself: before
    the study runs, round 1 of each arm that the (V_env, B_env) envelope
    pads (here all three: DEFL in V, FedAvg in b, Rand in both) runs as a
    one-member group in that envelope and is held to the member contract
    against a round of it alone; the probe raises if one breaks it. Then
    the study's 1 round."""
    probe = study.replace(max_rounds=1, target_acc=None, bit_check=True)
    t0 = time.perf_counter()
    res, launches = _launched(counters, lambda: probe.run(sims=sims))
    env = _padding_share(list(sims.values()))[1]
    padded = [label for label, sim in sims.items()
              if (sim.fed.local_rounds, sim.fed.batch_size) != env]
    print(f"[bit-check] Study(bit_check=True) on the Fig. 2 MNIST group on "
          f"{card}: probed {padded} "
          f"({', '.join(f'{k} b={v.fed.batch_size} V={v.fed.local_rounds}' for k, v in sims.items())}"
          f" in the (V_env, B_env) = {env} envelope), passed, then 1 round; "
          f"{time.perf_counter() - t0:.2f} s, launches {launches}",
          flush=True)
    if padded != [label for label, _ in study.arms] or res.groups != (
            tuple(label for label, _ in study.arms),):
        raise SystemExit("the bit_check probe did not probe every arm of "
                         "the Fig. 2 MNIST group")
    _check_uncompressed("bit-check", launches)
    return launches


def phase_study_cost(card, fig2):
    """(d): each Fig. 2 group's steady s/round (no eval) beside the sum of
    its members' s/round alone, its padding share, its peak memory and a
    profiled window. None of these is a gate."""
    import torch
    from repro_torch.federated import study as study_mod
    for ds, (study, sims, share, env) in fig2.items():
        tag = f"study-cost-{ds}"
        members = [study_mod._Member(arm=a, label=label, sim=sims[label],
                                     seed=seed)
                   for a, (label, _) in enumerate(study.arms)
                   for seed in study.seeds]
        R = STUDY_TIMED_ROUNDS
        study_mod._run_group(members, 1, 1, None, None)  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        study_mod._run_group(members, R, R, None, None)
        torch.cuda.synchronize()
        group_s = (time.perf_counter() - t0) / R
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        alone = {}
        for m in members:
            sim = m.sim
            sim.run_chunk(sim.init(m.seed), 1)  # warm-up
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sim.run_chunk(sim.init(m.seed), R)
            torch.cuda.synchronize()
            alone[m.label, m.seed] = (time.perf_counter() - t0) / R
        total = sum(alone.values())
        print(f"[{tag}] on {card}: group {group_s!r} s per round ({R} rounds, "
              f"no eval), sum of its {len(members)} members alone "
              f"{total!r} s per round ({', '.join(f'{k[0]}[{k[1]}] {v:.4f}' for k, v in alone.items())}); "
              f"group / sum {group_s / total:.3f}; envelope {env}, padding "
              f"{share:.1%} of the local-step work; peak "
              f"{peak:.2f} GiB", flush=True)
        _, wall, busy, top = profiled(
            lambda: study_mod._run_group(members, 1, 1, None, None))
        print(f"[{tag}] profiled 1 group round: wall {wall:.4f} s, device "
              f"busy {busy:.4f} s ({busy / wall:.1%}; idle "
              f"{1 - busy / wall:.1%}), profiler on", flush=True)
        for kname, sec in top[:8]:
            print(f"[{tag}]   {sec * 1e3:9.3f} ms/round {sec / busy:6.1%}  "
                  f"{kname[:90]}")
        print_fold_time(tag, top, busy, 1)


# -- serve paths -----------------------------------------------------------------

# arch: (the kernel its prefill runs, a substring of that kernel's symbol in
# the profiler, the device its weights are drawn on). qwen2-0.5b's 494M
# weights come from a CPU generator as `serve.main` draws them; the others'
# (falcon-mamba-7b 7.0e9, gemma-7b 8.5e9, zamba2-2.7b 2.3e9, musicgen-large
# 3.3e9) from a CUDA
# generator on the card (a CPU draw of 28 GB takes minutes), one layer at a
# time into the stacked leaves.
SERVE_ARCHS = {
    "qwen2-0.5b": ("flash_attention", "flash_fwd", "cpu"),
    "falcon-mamba-7b": ("selective_scan", "selective_scan_fwd", "cuda"),
    "gemma-7b": ("flash_attention", "flash_fwd", "cuda"),
    "zamba2-2.7b": ("flash_attention", "flash_fwd", "cuda"),
    "musicgen-large": ("flash_attention", "flash_fwd", "cuda"),
    "qwen3-moe-30b-a3b": ("flash_attention", "flash_fwd", "cuda"),
}
# Depth cuts (arch: layers served): qwen3-moe-30b-a3b's 48 layers hold
# 3.05e10 float32 parameters (122 GB), more than the card's 80 GB; 16 of
# them, at the published widths, hold 1.06e10 (39.5 GiB).
SERVE_DEPTH = {"qwen3-moe-30b-a3b": 16}


def prefill_launches(cfg):
    """The kernel launches a prefill of `cfg` makes: one a layer of an
    attention or mamba1 mixer (flash attention, selective scan), and one a
    shared block (flash attention; zamba2-2.7b: one after each of its 9
    groups of 6 mamba2 layers, whose SSD is plain torch)."""
    n = cfg.n_layers if cfg.mixer in ("attention", "mamba1") else 0
    return n + (cfg.n_scan_groups if cfg.shared_attn_every else 0)


def mixer_line(cfg):
    if cfg.mixer == "attention":
        a = cfg.attention
        line = f"{a.n_heads} heads / {a.n_kv_heads} kv of {a.head_dim}"
        if cfg.mlp == "moe":
            m = cfg.moe
            line += (f", MoE {m.n_experts} experts of {m.d_ff_expert}, top "
                     f"{m.top_k}, capacity factor {m.capacity_factor}")
            if m.shared_expert_d_ff:
                line += f", shared expert of {m.shared_expert_d_ff}"
        return line
    s = cfg.ssm
    if cfg.mixer == "mamba1":
        return f"mamba1 d_inner {s.expand * cfg.d_model} d_state {s.d_state}"
    from repro_torch.models import transformer as tfm
    sa = tfm.shared_attn_cfg(cfg)
    d_in = s.expand * cfg.d_model
    return (f"mamba2 d_inner {d_in} ({d_in // s.head_dim} heads of "
            f"{s.head_dim}) d_state {s.d_state}, shared block of "
            f"{sa.n_heads} heads of {sa.head_dim} after each of "
            f"{cfg.n_scan_groups} groups of {cfg.scan_group}")

# Kernel vs plain prefill logits, as a share of the largest logit. qwen2:
# the kernel keeps the scores in float32 where the plain path rounds them
# to bf16 (the reference's rounding points; both round P to bf16); through
# 24 bf16 layers the logits drift apart by about 2%. falcon-mamba-7b: the
# two paths differ only in the scan's float32 sum order, but where its y
# lands on the other side of a bf16 rounding boundary the gate's input
# moves by a bf16 ulp, and that travels through 64 layers. gemma-7b (28
# layers) and zamba2-2.7b (9 shared blocks between 54 plain mamba2 layers)
# differ as qwen2 does, in their attention. All gated at 5%.
SERVE_LOGIT_TOL = 0.05
# The same in float32, on prompts of 256 tokens: only the kernels' sum
# orders differ (a few float32 ulps a layer). 1e-4 of the largest logit,
# ten times the CPU tests' 1e-5 for 2 layers, for the 24 to 64 layers here.
SERVE_F32_PROMPT, SERVE_F32_LOGIT_TOL = 256, 1e-4


def phase_serve(counters, arch, prefill_times):
    """`arch` at full width and depth through serve.generate; returns the
    launches of every kernel in that generate, and puts (the config
    served, its prompts' shape, the prefill's seconds) in
    `prefill_times[arch]` (phase 27 (c))."""
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.launch import serve
    from repro_torch.models import transformer as tfm
    from repro_torch.utils.tree import leaves
    kernel, symbol, gen_device = SERVE_ARCHS[arch]
    ops = counters[kernel]
    cfg = get_config(arch)
    if arch in SERVE_DEPTH:
        print(f"[serve] {arch}: depth cut from {cfg.n_layers} to "
              f"{SERVE_DEPTH[arch]} layers, every width as published "
              f"({cfg.param_count()[0]:,} float32 parameters at full depth "
              f"do not fit the card)", flush=True)
        cfg = cfg.replace(n_layers=SERVE_DEPTH[arch])
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = tfm.init_params(
        cfg, torch.Generator(device=gen_device).manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in leaves(params))
    per_prefill = prefill_launches(cfg)
    print(f"[serve] {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}"
          f", {mixer_line(cfg)}, vocab {cfg.vocab_size}, {n_params:,} "
          f"parameters "
          f"(float32, {cfg.dtype} compute; param_count() "
          f"{cfg.param_count()[0]:,}), drawn on {gen_device} in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    # (B, S) token ids, (B, S, K) codebook tokens for audio.
    prompts = serve.make_prompts(cfg, SERVE_BATCH, SERVE_PROMPT, seed=0)
    tok_shape = (SERVE_BATCH, 1, *prompts.shape[2:])
    serve.generate(cfg, params, prompts, 2)  # warm-up: cuBLAS, allocator

    for c in counters.values():
        c.launches = 0
    res = serve.generate(cfg, params, prompts, SERVE_GEN)
    launches = {name: c.launches for name, c in counters.items()}
    B, S = prompts.shape[:2]
    steps = SERVE_GEN - 1
    print(f"[serve] {arch} generate B={B} prompt={S} gen={SERVE_GEN}: "
          f"prefill {res.prefill_s:.4f} s ({B * S / res.prefill_s:.1f} "
          f"tokens/s), decode {steps} steps in {res.decode_s:.4f} s "
          f"({B * steps / res.decode_s:.2f} tokens/s, "
          f"{res.decode_s / steps * 1e3:.2f} ms a step), launches {launches}"
          f", peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    prefill_times[arch] = (cfg, B, S, res.prefill_s)
    if tuple(res.tokens.shape) != (B, SERVE_GEN, *prompts.shape[2:]):
        raise SystemExit(f"generated {tuple(res.tokens.shape)} tokens")
    print(f"[serve] {arch} tokens {tuple(res.tokens.shape)}, prefill logits "
          f"{tuple(res.prefill_logits.shape)}", flush=True)
    if not (int(res.tokens.min()) >= 0
            and int(res.tokens.max()) < cfg.vocab_size):
        raise SystemExit("generated token ids out of the vocabulary")
    for name, t in (("prefill", res.prefill_logits),
                    ("last decode", res.last_logits)):
        if not bool(torch.isfinite(t).all()):
            raise SystemExit(f"non-finite {name} logits")
    if launches[kernel] != per_prefill:
        raise SystemExit(f"expected {per_prefill} {kernel} launches in "
                         f"generate, got {launches[kernel]}")
    others = {k: n for k, n in launches.items() if k != kernel and n}
    if others:
        raise SystemExit(f"other kernels launched on the {arch} path: "
                         f"{others}")

    # The prefill alone, profiled: one kernel launch a layer (a shared
    # block). Then decode steps from its cache, profiled: no kernel launch.
    ops.launches = 0
    (logits, cache), wall, busy, top = profiled(lambda: tfm.prefill(
        cfg, params, prompts.cuda(), max_len=S + SERVE_GEN, impl="kernel"))
    n_prefill = ops.launches
    kernel_s = sum(sec for name, sec in top if symbol in name)
    print(f"[serve] {arch} profiled prefill: wall {wall:.4f} s, device busy "
          f"{busy:.4f} s ({busy / wall:.1%}), {kernel} kernel "
          f"{kernel_s * 1e3:.3f} ms = {kernel_s / busy:.1%} of device time "
          f"over {n_prefill} launches, profiler on", flush=True)
    for name, sec in top[:8]:
        print(f"[serve]   {sec * 1e3:9.3f} ms {sec / busy:6.1%}  {name[:90]}")
    if n_prefill != per_prefill:
        raise SystemExit(f"expected {per_prefill} {kernel} launches a "
                         f"prefill, got {n_prefill}")
    tok = logits[:, -1].argmax(dim=-1).reshape(tok_shape)
    ops.launches = 0
    n_steps = min(8, SERVE_GEN - 1)  # within the cache's max_len

    def decode_steps(tok=tok):
        for _ in range(n_steps):
            out, _ = tfm.decode_step(cfg, params, cache, tok)
            tok = out[:, 0].argmax(dim=-1).reshape(tok_shape)
        return tok

    _, wall, busy, top = profiled(decode_steps)
    print(f"[serve] {arch} profiled {n_steps} decode steps: wall {wall:.4f} "
          f"s, device busy {busy:.4f} s ({busy / wall:.1%}; idle "
          f"{1 - busy / wall:.1%}), {kernel} launches {ops.launches}, "
          "profiler on", flush=True)
    for name, sec in top[:8]:
        print(f"[serve]   {sec / n_steps * 1e3:9.3f} ms/step "
              f"{sec / busy:6.1%}  {name[:90]}")
    if ops.launches:
        raise SystemExit(f"decode launched the {kernel} kernel "
                         f"{ops.launches} times")
    del logits, cache
    if cfg.mlp == "moe":
        with moe_probe() as calls:
            tfm.prefill(cfg, params, prompts.cuda(), impl="kernel")
        print_moe_probe(f"{arch} prefill", cfg, calls)

    # The kernel path against the plain path, same weights and prompts.
    plain = serve.generate(cfg, params, prompts, 1, impl="plain")
    gap = float((res.prefill_logits - plain.prefill_logits).abs().max())
    scale = float(plain.prefill_logits.abs().max())
    rel_l2 = float((res.prefill_logits - plain.prefill_logits).norm()
                   / plain.prefill_logits.norm())
    same_first = int((res.tokens[:, 0] == plain.tokens[:, 0]).reshape(
        B, -1).all(dim=1).sum())
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
          f"{int((got.tokens == want.tokens).flatten(1).all(dim=1).sum())}"
          f"/{B} rows", flush=True)
    if not gap <= SERVE_F32_LOGIT_TOL * scale:
        raise SystemExit("kernel and plain float32 prefill logits disagree")
    return launches


# arch: float32 (prefill, last decode) logit tolerances, as the CPU tests
# (tests/test_torch_transformer.py, tests/test_torch_mamba.py) hold them:
# 1e-5 of scale, 1e-4 after qwen2's decode through its bf16 KV cache
# (falcon-mamba-7b's decode state is float32). bf16: 3e-2 for both.
SERVE_REF_F32_TOL = {"qwen2-0.5b": (1e-5, 1e-4),
                     "falcon-mamba-7b": (1e-5, 1e-5),
                     "gemma-7b": (1e-5, 1e-4), "zamba2-2.7b": (1e-5, 1e-4),
                     # A bf16 cache element a rounding step apart moves the
                     # decode logits of 4 codebook heads by up to 1.5e-4
                     # (tests/test_torch_musicgen.py).
                     "musicgen-large": (1e-5, 1e-3),
                     # As tests/test_torch_moe_archs.py holds them.
                     **{arch: (1e-5, 1e-3) for arch in (
                         "qwen3-moe-30b-a3b", "moonshot-v1-16b-a3b",
                         "llama4-scout-17b-a16e", "qwen3-32b",
                         "llava-next-34b")}}
# Phase 26: the smoke configs of the MoE family and its neighbours, card vs
# CPU.
MOE_FAMILY = ("qwen3-moe-30b-a3b", "moonshot-v1-16b-a3b",
              "llama4-scout-17b-a16e", "qwen3-32b", "llava-next-34b")


@contextlib.contextmanager
def moe_probe():
    """Within the block, every call of the transformer's MoE layer records
    its capacity C, its token count and, as device tensors (read after the
    block, so no host sync is added), its dropped share and the router's
    smallest top-k margin: the least gap, over the tokens, between the
    k-th and the (k+1)-th largest router probability (float32, from the
    layer's own input). A margin near 0 is a near-tie, where float32 sums
    in another order can change an expert."""
    from repro_torch.models import moe
    from repro_torch.models import transformer as tfm
    inner, calls = tfm.moe_forward, []

    def recorded(p, x, cfg, act="silu", capacity_factor=None):
        out, metrics = inner(p, x, cfg, act, capacity_factor)
        r = moe.route(p, x.reshape(-1, x.shape[-1]), cfg, capacity_factor)
        top = moe.top_k(r.probs, cfg.top_k + 1)[0]
        calls.append((r.capacity, x.shape[0] * x.shape[1],
                      metrics["drop_frac"], (top[:, -2] - top[:, -1]).min()))
        return out, metrics

    tfm.moe_forward = recorded
    try:
        yield calls
    finally:
        tfm.moe_forward = inner


def print_moe_probe(tag, cfg, calls):
    """One line: the prefill's capacity and dropped share in each layer (the
    first n_layers calls), the decode steps' (the rest) largest dropped
    share, and the smallest router margin over all calls. Returns that
    margin."""
    n = cfg.n_layers
    drops = [float(d) for _, _, d, _ in calls]
    margin = min(float(m) for *_, m in calls)
    (C, T, *_), rest = calls[0], calls[n:]
    line = (f"[moe] {tag}: prefill of T={T} tokens, C={C} slots an expert "
            f"({cfg.moe.n_experts} experts, top {cfg.moe.top_k}), dropped "
            f"share by layer {[round(d, 4) for d in drops[:n]]} (mean "
            f"{statistics.mean(drops[:n]):.4f})")
    if rest:
        line += (f"; {len(rest) // n} decode steps of T={rest[0][1]}, C="
                 f"{rest[0][0]}, largest dropped share {max(drops[n:]):.4f}")
    print(line + f"; smallest router top-k margin {margin:.3g}", flush=True)
    return margin


def smoke_variants(arch):
    """name -> ModelConfig.replace arguments of the smoke configs compared
    card vs CPU: the smoke config itself and, for gemma-7b and zamba2-2.7b,
    a variant at the full config's attention head_dim (256; the shared
    block's 80), so the card runs that kernel instance inside a model."""
    from repro_torch.configs.base import AttentionConfig
    variants = {"smoke": {}}
    if arch == "gemma-7b":
        variants["smoke hd256"] = {"attention": AttentionConfig(
            n_heads=2, n_kv_heads=2, head_dim=256)}
    if arch == "zamba2-2.7b":
        variants["smoke hd80"] = {"d_model": 160, "shared_attn_heads": 2}
    if arch in ("musicgen-large", "llava-next-34b"):
        # The smoke config again, with a conditioning prefix (musicgen) or
        # patch embeddings (llava) through prefill(prefix_embeds=) (not a
        # ModelConfig field).
        variants["smoke prefix"] = {}
    return variants


def phase_serve_reference(arch):
    """`arch`'s smoke configs on the card and on the CPU (where the kernels'
    wrappers run their plain versions), same weights and prompts, in
    float32 and in bf16; float32 greedy tokens identical. Returns the
    flash kernel's launches in the card's generates, counted from 0 just
    before each."""
    return sum(serve_reference(arch, variant, kw)
               for variant, kw in smoke_variants(arch).items())


def serve_reference(arch, variant, kw):
    """One smoke config, card vs CPU. In bf16 a head-dim variant (not the
    arch's own smoke config) or a musicgen-large config may flip a greedy
    token where the CPU's two candidates are a near-tie: the flip must be
    at a step where the CPU's logits of the card's token and of its own lie
    within the bf16 tolerance of each other, and the last logits are
    compared on the rows whose tokens all agree (at least one), as the CPU
    tests compare them with the reference (tests/test_torch_transformer.py).
    An MoE config may too in bf16: its router sees bf16 activations a
    rounding step apart, and an expert swapped at a near-tie of the router
    moves a token's output. The "smoke prefix" variant passes a (B,
    prefix_len, embed_dim) conditioning prefix or patch embeddings to
    generate (prefill(prefix_embeds=)). An MoE config also prints the
    router's smallest top-k margin and the dropped share of each layer (the
    card's run), and a float32 token that differs names that margin.
    Returns the flash launches of the card's generates."""
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels.flash_attention import ops as flash
    from repro_torch.launch import serve
    from repro_torch.models import transformer as tfm
    from repro_torch.utils.tree import tree_map
    launched = 0
    for dtype, (tol_first, tol_last) in (
            ("float32", SERVE_REF_F32_TOL[arch]), ("bfloat16", (3e-2, 3e-2))):
        cfg = get_config(arch, smoke=True).replace(dtype=dtype, **kw)
        cpu = tfm.init_params(cfg, torch.Generator().manual_seed(3),
                              device="cpu")
        gpu = tree_map(lambda t: t.cuda(), cpu)
        prompts = serve.make_prompts(cfg, 3, 150, seed=4)
        prefix = None
        if variant == "smoke prefix":
            m = cfg.modality
            prefix = torch.randn((3, m.prefix_len, m.embed_dim),
                                 generator=torch.Generator().manual_seed(5))
        flash.launches = 0
        with moe_probe() as calls:
            out = {"cuda": serve.generate(cfg, gpu, prompts, 4,
                                          prefix_embeds=prefix)}
        launched += flash.launches
        out["cpu"] = serve.generate(cfg, cpu, prompts, 4, device="cpu",
                                    prefix_embeds=prefix)
        margin = (print_moe_probe(f"{arch} {variant} {dtype} card", cfg,
                                  calls) if calls else None)
        agree = (out["cuda"].tokens.cpu() == out["cpu"].tokens).flatten(
            1).all(dim=1)
        rows, flips = torch.ones_like(agree), ""
        if (dtype == "bfloat16" and (variant != "smoke" or cfg.modality
                                     or cfg.mlp == "moe")
                and not agree.all()):
            flips = near_tie_flips(cfg, cpu, prompts, out, prefix=prefix)
            rows = agree
            if not rows.any():
                raise SystemExit(f"serve {arch} {variant}: no row's tokens "
                                 f"agree card vs CPU")
        gaps = []
        for field, tol in (("prefill_logits", tol_first),
                           ("last_logits", tol_last)):
            a = getattr(out["cuda"], field).cpu()
            b = getattr(out["cpu"], field)
            if field == "last_logits":
                a, b = a[rows], b[rows]
            scale = max(1.0, float(b.abs().max()))
            gaps.append(float((a - b).abs().max()) / scale)
            if not gaps[-1] <= tol:
                raise SystemExit(f"serve {arch} {variant} {dtype} {field}: "
                                 f"card and CPU differ by {gaps[-1]:.3g} of "
                                 f"scale")
        same = bool(torch.equal(out["cuda"].tokens.cpu(), out["cpu"].tokens))
        print(f"[reference] {arch} {variant} {dtype} cuda vs cpu: prefill "
              f"logit gap {gaps[0]:.3g}, last logit gap {gaps[1]:.3g} of "
              f"scale (on {int(rows.sum())}/{len(rows)} rows), tokens "
              f"identical: {same}{flips}", flush=True)
        if dtype == "float32" and not same:
            raise SystemExit(
                "float32 greedy tokens differ, card vs CPU"
                + ("" if margin is None else
                   f" (smallest router top-k margin {margin:.3g})"))
    return launched


def near_tie_flips(cfg, cpu_params, prompts, out, tol=3e-2, prefix=None):
    """Each row whose greedy tokens differ card vs CPU: at its first
    differing step t, each differing token (each codebook's, for audio)
    must be a near-tie on the CPU, |logit(card's token) - logit(CPU's
    token)| <= tol * max(1, max |logit|) of the CPU's logits at step t (a
    generate of t + 1 tokens). Returns a line for the print."""
    import torch
    from repro_torch.launch import serve
    card, host = out["cuda"].tokens.cpu(), out["cpu"].tokens
    B, gen = card.shape[:2]
    card, host = card.reshape(B, gen, -1), host.reshape(B, gen, -1)
    notes = []
    for r in torch.nonzero((card != host).flatten(1).any(dim=1)).flatten(
            ).tolist():
        t = int(torch.nonzero((card[r] != host[r]).any(dim=1))[0])
        res = serve.generate(cfg, cpu_params, prompts, t + 1, device="cpu",
                             prefix_embeds=prefix)
        logits = (res.prefill_logits if t == 0 else res.last_logits)[r, -1]
        logits = logits.reshape(-1, cfg.vocab_size)  # (K or 1, V)
        for k in torch.nonzero(card[r, t] != host[r, t]).flatten().tolist():
            gap = float(logits[k, host[r, t, k]] - logits[k, card[r, t, k]])
            scale = max(1.0, float(logits[k].abs().max()))
            notes.append(f"row {r} step {t} head {k}: card token "
                         f"{int(card[r, t, k])}, CPU token "
                         f"{int(host[r, t, k])}, CPU logit gap "
                         f"{gap / scale:.3g} of scale")
            if not gap <= tol * scale:
                raise SystemExit(f"serve {cfg.name}: a greedy token flips "
                                 f"card vs CPU where the CPU's logits are no "
                                 f"near-tie: {notes[-1]}")
    return "; near-tie flips: " + "; ".join(notes)


# -- training (phase 24) ---------------------------------------------------------

# (a): launch/train.py at qwen2-0.5b's full width, as a user runs it. With
# --defl the plan's batch (b* = 256 at 1.98 GB of update, capped at 64)
# replaces --batch 8; V = 2 stays.
TRAIN_ARGV = ["--arch", "qwen2-0.5b", "--clients", "2", "--batch", "8",
              "--seq", "128", "--V", "2", "--rounds", "2", "--defl"]
# (b): the smoke configs trained card vs CPU from equal weights and
# batches: (loss relative, params of each leaf's largest |value|). float32
# as tests/test_torch_train.py holds the port to the reference; bf16 at the
# serve references' 3e-2 (the bf16 flash kernel against the plain version
# in float32, each output rounded once).
TRAIN_REF_TOL = {"float32": (1e-5, 1e-5), "bfloat16": (3e-2, 3e-2)}
# (c): one attention layer's gradients through the kernel against the plain
# path, of the largest |gradient| (tests/test_torch_train_cuda.py).
ATTN_GRAD_TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def phase_train(counters, card, dev):
    """24 (a): train.py at qwen2-0.5b's full width on the card. Returns
    (the kernels' launches in its 2 rounds, the trainer)."""
    import numpy as np
    import torch
    from repro_torch.launch import train
    args = train.build_parser().parse_args(TRAIN_ARGV + ["--device",
                                                         str(dev)])
    torch.cuda.reset_peak_memory_stats()
    for c in counters.values():
        c.launches = 0
    t0 = time.perf_counter()
    trainer = train.Trainer(args)
    setup_s = time.perf_counter() - t0
    for _ in range(args.rounds):
        trainer.run_round()
    torch.cuda.synchronize()
    launches = {name: c.launches for name, c in counters.items()}
    res, cfg = trainer.result, trainer.cfg
    # The plan from the analytic parameter count on the host (numpy only),
    # not from the card's tree.
    _, want_line = train.plan_fed(args, cfg.param_count()[0] * 32)
    b = trainer.iters[0].batch
    per_round = cfg.n_layers * trainer.V * args.clients
    round1 = float(np.mean(res.losses[0]))
    print(f"[train] {cfg.name} at full width ({cfg.param_count()[0]:,} "
          f"float32 parameters, {cfg.dtype} compute, impl=kernel): "
          f"{args.clients} clients x V={trainer.V} steps of batch {b} x "
          f"{args.seq + 1} tokens, {args.rounds} rounds; set-up (init on the "
          f"CPU, token streams) {setup_s:.2f} s; s/round {res.wall_s}; "
          f"losses by round {[r.tolist() for r in res.losses]}; round 1 "
          f"mean {round1:.4f} vs ln(vocab) {math.log(cfg.vocab_size):.4f}; "
          f"sim_time {res.sim_time}; launches {launches}; peak device "
          f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB",
          flush=True)
    print(f"[train] plan line {res.plan_line!r}, host recomputation "
          f"{want_line!r}", flush=True)
    if res.plan_line != want_line:
        raise SystemExit("the DEFL plan line differs from its host "
                         "recomputation")
    if launches["flash_attention"] != per_round * args.rounds:
        raise SystemExit(f"expected {per_round * args.rounds} flash launches "
                         f"(24 layers x V x clients x rounds), got "
                         f"{launches['flash_attention']}")
    if launches["fold_matmul"] < args.rounds or launches["quantize"] or \
            launches["selective_scan"]:
        raise SystemExit(f"training launched other kernels, or no FedAvg "
                         f"fold matmul: {launches}")
    if not all(np.isfinite(r).all() for r in res.losses) or not abs(
            round1 - math.log(cfg.vocab_size)) < 2.0:
        raise SystemExit("training losses are not finite, or round 1 is not "
                         "within 2 of ln(vocab)")
    # One more round, profiled: busy share and device time by kernel.
    n = counters["flash_attention"].launches
    _, wall, busy, top = profiled(trainer.run_round)
    flash_s = sum(sec for name, sec in top if "flash_fwd" in name)
    print(f"[train] profiled round: wall {wall:.4f} s, device busy "
          f"{busy:.4f} s ({busy / wall:.1%}; idle {1 - busy / wall:.1%}), "
          f"flash kernel {flash_s * 1e3:.3f} ms = {flash_s / busy:.1%} of "
          f"device time over {counters['flash_attention'].launches - n} "
          f"launches, profiler on; on {card}", flush=True)
    for name, sec in top[:10]:
        print(f"[train]   {sec * 1e3:9.3f} ms {sec / busy:6.1%}  {name[:90]}")
    return launches, trainer


def _leaf_gap(a, b):
    """The largest |a - b| of any leaf over that leaf's largest |b|."""
    from repro_torch.utils.tree import leaves
    return max(float((x.cpu().float() - y.float()).abs().max())
               / (float(y.float().abs().max()) or 1.0)
               for x, y in zip(leaves(a), leaves(b)))


def _audio_steps(cfg, params, batches, device):
    """V local SGD steps of one client on (V, B, S, K) codebook batches
    with a prefix (client.make_local_update over the loss's
    value_and_grad): (params', the V losses)."""
    from repro_torch.federated.client import make_local_update
    from repro_torch.launch import train
    from repro_torch.optim import sgd
    from repro_torch.utils.tree import tree_map
    update = make_local_update(train.value_and_grad_fn(cfg), sgd(0.05))
    p, _, losses = update(params, (), tree_map(lambda t: t.to(device),
                                              batches))
    return p, losses.cpu()


def phase_train_reference(counters, dev):
    """24 (b): the qwen2-0.5b smoke config through train.run and the
    musicgen-large smoke config (codebooks and a prefix) through its local
    steps, card vs CPU from equal weights and batches, float32 and bf16."""
    import numpy as np
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.launch import train
    from repro_torch.models import transformer as tfm
    from repro_torch.utils.tree import tree_map
    argv = ["--smoke", "--rounds", "2", "--clients", "2", "--batch", "2",
            "--seq", "32", "--V", "2", "--defl"]
    for dtype, (loss_tol, param_tol) in TRAIN_REF_TOL.items():
        cfg = get_config("qwen2-0.5b", smoke=True).replace(dtype=dtype)
        cpu = tfm.init_params(cfg, torch.Generator().manual_seed(6),
                              device="cpu")
        n = counters["flash_attention"].launches
        got = train.run(argv + ["--device", str(dev)],
                        params=tree_map(lambda t: t.to(dev), cpu), cfg=cfg)
        n = counters["flash_attention"].launches - n
        want = train.run(argv + ["--device", "cpu"], params=cpu, cfg=cfg)
        loss_gap = float(np.max(np.abs(np.stack(got.losses)
                                       - np.stack(want.losses))
                                / np.abs(np.stack(want.losses))))
        param_gap = _leaf_gap(got.params, want.params)
        print(f"[train] qwen2-0.5b smoke {dtype} card vs CPU, 2 rounds x 2 "
              f"clients x V=2: losses {loss_gap:.3g} relative (tol "
              f"{loss_tol:g}), params {param_gap:.3g} of scale (tol "
              f"{param_tol:g}), sim_time equal {got.sim_time == want.sim_time}"
              f", {n} flash launches", flush=True)
        if not (loss_gap <= loss_tol and param_gap <= param_tol
                and got.sim_time == want.sim_time and n == 2 * 2 * 2 * 2):
            raise SystemExit(f"qwen2 smoke training {dtype}: card and CPU "
                             f"disagree")

        cfg = get_config("musicgen-large", smoke=True).replace(dtype=dtype)
        m = cfg.modality
        g = torch.Generator().manual_seed(7)
        cpu = tfm.init_params(cfg, g, device="cpu")
        batches = {"tokens": torch.randint(0, cfg.vocab_size,
                                           (2, 2, 33, m.n_codebooks),
                                           generator=g),
                   "prefix_embeds": torch.randn((2, 2, m.prefix_len,
                                                 m.embed_dim), generator=g)}
        n = counters["flash_attention"].launches
        p_card, l_card = _audio_steps(
            cfg, tree_map(lambda t: t.to(dev), cpu), batches, dev)
        n = counters["flash_attention"].launches - n
        p_cpu, l_cpu = _audio_steps(cfg, cpu, batches, "cpu")
        loss_gap = float(((l_card - l_cpu).abs() / l_cpu.abs()).max())
        param_gap = _leaf_gap(p_card, p_cpu)
        print(f"[train] musicgen-large smoke {dtype} (prefix {m.prefix_len}, "
              f"{m.n_codebooks} codebooks) card vs CPU, V=2 steps: losses "
              f"{l_card.tolist()} vs {l_cpu.tolist()} ({loss_gap:.3g} "
              f"relative), params {param_gap:.3g} of scale, {n} flash "
              f"launches", flush=True)
        if not (loss_gap <= loss_tol and param_gap <= param_tol
                and n == 2 * cfg.n_layers):
            raise SystemExit(f"musicgen smoke training {dtype}: card and "
                             f"CPU disagree")


def phase_train_grads(counters, trainer, dev):
    """24 (c): one qwen2-0.5b attention layer (the trained model's layer 0,
    at the training batch's shape) through the kernel against the plain
    path, float32 and bf16; wq, wk, wv must get nonzero gradients."""
    import torch
    from repro_torch.models import attention
    from repro_torch.utils.tree import tree_map
    cfg = trainer.cfg
    p0 = tree_map(lambda t: t[0, 0].detach(), trainer.result.params["layers"]
                  ["attn"])
    B, S = trainer.iters[0].batch, trainer.args.seq + 1
    g = torch.Generator(device=dev).manual_seed(8)
    x32 = torch.randn((B, S, cfg.d_model), generator=g, device=dev)
    up32 = torch.randn((B, S, cfg.d_model), generator=g, device=dev)
    pos = torch.arange(S, device=dev)[None].expand(B, S)
    for dtype, tol in ATTN_GRAD_TOL.items():
        x, up = (t.to(getattr(torch, dtype)) for t in (x32, up32))
        grads = {}
        for impl in ("kernel", "plain"):
            p = tree_map(lambda t: t.clone().requires_grad_(True), p0)
            n = counters["flash_attention"].launches
            out = attention.attention_forward(p, x, cfg.attention, pos, impl)
            names = sorted(p)
            gs = torch.autograd.grad(out, [p[k] for k in names], up)
            grads[impl] = dict(zip(names, gs))
            launched = counters["flash_attention"].launches - n
            if launched != (impl == "kernel"):
                raise SystemExit(f"{impl} attention launched flash "
                                 f"{launched} times (forward and backward)")
        gaps = {k: float((grads["kernel"][k].float()
                          - grads["plain"][k].float()).abs().max())
                / float(grads["plain"][k].float().abs().max())
                for k in grads["plain"]}
        sizes = {k: float(grads["kernel"][k].abs().max())
                 for k in ("wq", "wk", "wv")}
        print(f"[train] qwen2-0.5b attention layer ({B}, {S}, "
              f"{cfg.d_model}) {dtype}: gradients through the kernel vs the "
              f"plain path, of max |g|: "
              + ", ".join(f"{k} {v:.3g}" for k, v in sorted(gaps.items()))
              + f" (tol {tol:g}); max |g| of wq, wk, wv {sizes}", flush=True)
        if not all(v <= tol for v in gaps.values()) or not all(
                sizes.values()):
            raise SystemExit(f"attention gradients through the kernel "
                             f"({dtype}) disagree with the plain path or are "
                             f"zero")


# 24 (e), (f): train.py at the smoke configs of an MoE arch and of the
# mamba1 arch, as a user runs them (`--smoke`, one round).
SMOKE_TRAIN_ARGV = ["--smoke", "--rounds", "1", "--clients", "2", "--batch",
                    "2", "--seq", "32", "--V", "2", "--defl"]
# 24 (f): the scan's gradients through the kernel against the plain path,
# of each leaf's largest |gradient| (tests/test_torch_train_cuda.py).
SCAN_GRAD_TOL = 1e-5


def _train_smoke(counters, arch, dev, **kw):
    """train.py --arch `arch` SMOKE_TRAIN_ARGV on `dev`; returns (result,
    config, args, V, the kernels' launches counted from 0)."""
    from repro_torch.launch import train
    argv = ["--arch", arch] + SMOKE_TRAIN_ARGV + ["--device", str(dev)]
    args = train.build_parser().parse_args(argv)
    for c in counters.values():
        c.launches = 0
    trainer = train.Trainer(args, **kw)
    for _ in range(args.rounds):
        trainer.run_round()
    launches = {name: c.launches for name, c in counters.items()}
    return trainer.result, trainer.cfg, args, trainer.V, launches


def phase_train_moe(counters, dev):
    """24 (e): train.py --arch qwen3-moe-30b-a3b --smoke on the card (its
    bf16 config): the plan line equal to its host recomputation, finite
    losses, one flash launch a layer and local step; the loss at the
    trained params carries the router's aux loss (loss = ce + aux, aux >
    0). Then the float32 config card vs CPU from equal weights: losses
    and params within 1e-5. Returns the launches of the bf16 round."""
    import numpy as np
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.launch import train
    from repro_torch.models import transformer as tfm
    from repro_torch.utils.tree import tree_map
    arch = "qwen3-moe-30b-a3b"
    res, cfg, args, V, launches = _train_smoke(counters, arch, dev)
    _, want_line = train.plan_fed(args, cfg.param_count()[0] * 32)
    per_round = cfg.n_layers * V * args.clients
    batch = torch.randint(0, cfg.vocab_size, (2, args.seq + 1), device=dev,
                          generator=torch.Generator(device=dev).manual_seed(9))
    with torch.no_grad():
        loss, m = tfm.loss_fn(cfg, res.params, {"tokens": batch}, "kernel")
    loss, ce, aux = (float(t) for t in (loss, m["ce_loss"], m["aux_loss"]))
    print(f"[train] {arch} smoke ({cfg.dtype}, {cfg.moe.n_experts} experts, "
          f"top {cfg.moe.top_k}) train.py on the card: {args.clients} "
          f"clients x V={V}, losses {[r.tolist() for r in res.losses]}, "
          f"launches {launches}; plan line {res.plan_line!r}, host "
          f"recomputation {want_line!r}; loss_fn at the trained params "
          f"{loss:.6f} = ce {ce:.6f} + aux {aux:.6f}", flush=True)
    if res.plan_line != want_line:
        raise SystemExit(f"{arch}: the plan line differs from its host "
                         f"recomputation")
    if not all(np.isfinite(r).all() for r in res.losses):
        raise SystemExit(f"{arch}: non-finite training losses")
    if launches["flash_attention"] != per_round * args.rounds or             launches["selective_scan"] or launches["quantize"]:
        raise SystemExit(f"{arch}: expected {per_round * args.rounds} flash "
                         f"launches and no scan or quantize, got {launches}")
    if not (aux > 0 and abs(loss - (ce + aux)) <= 1e-6 * abs(loss)):
        raise SystemExit(f"{arch}: the loss does not carry the aux loss")

    cfg32 = get_config(arch, smoke=True).replace(dtype="float32")
    cpu = tfm.init_params(cfg32, torch.Generator().manual_seed(10),
                          device="cpu")
    argv = ["--arch", arch] + SMOKE_TRAIN_ARGV
    got = train.run(argv + ["--device", str(dev)],
                    params=tree_map(lambda t: t.to(dev), cpu), cfg=cfg32)
    want = train.run(argv + ["--device", "cpu"], params=cpu, cfg=cfg32)
    loss_gap = float(np.max(np.abs(np.stack(got.losses)
                                   - np.stack(want.losses))
                            / np.abs(np.stack(want.losses))))
    param_gap = _leaf_gap(got.params, want.params)
    print(f"[train] {arch} smoke float32 card vs CPU, 1 round x 2 clients x "
          f"V=2: losses {loss_gap:.3g} relative, params {param_gap:.3g} of "
          f"scale (tol {TRAIN_REF_TOL['float32']})", flush=True)
    if not (loss_gap <= TRAIN_REF_TOL["float32"][0]
            and param_gap <= TRAIN_REF_TOL["float32"][1]):
        raise SystemExit(f"{arch} smoke training: card and CPU disagree")
    return launches


def phase_train_scan(counters, dev):
    """24 (f): falcon-mamba-7b's smoke config in float32 on the card: the
    loss and every gradient leaf through the scan kernel (one launch a
    layer; its backward is the plain version's VJP) against the plain path
    (impl="plain"), within 1e-5 of each leaf's largest |gradient|, and
    every mixer leaf's gradient nonzero. Then train.py --arch
    falcon-mamba-7b --smoke (bf16) takes a round on the card: finite
    losses, one scan launch a layer and local step. Returns the scan's
    launches in that round."""
    import numpy as np
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.launch import train
    from repro_torch.models import transformer as tfm
    from repro_torch.utils.tree import leaves, tree_map
    arch = "falcon-mamba-7b"
    scan = counters["selective_scan"]
    cfg = get_config(arch, smoke=True).replace(dtype="float32")
    params = tfm.init_params(cfg, torch.Generator().manual_seed(11),
                             device=dev)
    tokens = torch.randint(0, cfg.vocab_size, (1, 2, 65), device=dev,
                           generator=torch.Generator(device=dev).manual_seed(
                               12))
    one = tree_map(lambda t: t[None], params)
    scan.launches = 0
    g_k, l_k = train.value_and_grad_fn(cfg, "kernel")(one, {"tokens": tokens})
    n = scan.launches
    g_p, l_p = train.value_and_grad_fn(cfg, "plain")(one, {"tokens": tokens})
    loss_gap = abs(float(l_k) - float(l_p)) / abs(float(l_p))
    gaps = [float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
            for a, b in zip(leaves(g_k), leaves(g_p))]
    sizes = {k: float(t.abs().max())
             for k, t in g_k["layers"]["mamba"].items()}
    print(f"[train] {arch} smoke float32 (d_inner "
          f"{cfg.ssm.expand * cfg.d_model}, d_state {cfg.ssm.d_state}) on the "
          f"card: loss {float(l_k):.6f}, {loss_gap:.3g} relative to the plain "
          f"path; gradients through the scan kernel ({n} launches) vs the "
          f"plain path: largest gap {max(gaps):.3g} of a leaf's max |g| over "
          f"{len(gaps)} leaves (tol {SCAN_GRAD_TOL:g}); mixer leaves' max "
          f"|g| {sizes}", flush=True)
    if n != cfg.n_layers or scan.launches != n:
        raise SystemExit(f"the scan launched {n} times in the kernel's loss "
                         f"and {scan.launches - n} in the plain one; expected "
                         f"{cfg.n_layers} and 0")
    if not (loss_gap <= SCAN_GRAD_TOL and max(gaps) <= SCAN_GRAD_TOL
            and all(sizes.values())):
        raise SystemExit("gradients through the scan kernel disagree with "
                         "the plain path or are zero")
    res, cfg, args, V, launches = _train_smoke(counters, arch, dev)
    want = cfg.n_layers * V * args.clients * args.rounds
    print(f"[train] {arch} smoke ({cfg.dtype}) train.py on the card: "
          f"{args.clients} clients x V={V}, losses "
          f"{[r.tolist() for r in res.losses]}, launches {launches}",
          flush=True)
    if not all(np.isfinite(r).all() for r in res.losses):
        raise SystemExit(f"{arch}: non-finite training losses")
    if launches["selective_scan"] != want or launches["flash_attention"]:
        raise SystemExit(f"{arch}: expected {want} scan launches and no "
                         f"flash, got {launches}")
    return launches


def phase_train_checkpoint(trainer):
    """24 (d): the trained params through checkpoint/io.py and back, bit for
    bit."""
    import tempfile

    import torch
    from repro_torch.checkpoint import load_checkpoint, save_checkpoint
    from repro_torch.utils.tree import leaves, tree_map
    params = trainer.result.params
    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "qwen2.msgpack")
        t0 = time.perf_counter()
        save_checkpoint(path, params, metadata={
            "arch": trainer.cfg.name, "round": len(trainer.result.sim_time),
            "sim_time": trainer.result.sim_time[-1]})
        save_s = time.perf_counter() - t0
        size = Path(path).stat().st_size
        t0 = time.perf_counter()
        got, meta = load_checkpoint(path, tree_map(torch.empty_like, params))
        load_s = time.perf_counter() - t0
    same = all(a.device == b.device and a.dtype == b.dtype
               and torch.equal(a, b)
               for a, b in zip(leaves(got), leaves(params)))
    print(f"[train] checkpoint of the trained params: {size / 1e9:.3f} GB, "
          f"saved in {save_s:.2f} s, loaded in {load_s:.2f} s, metadata "
          f"{meta}, bit for bit: {same}", flush=True)
    if not same or meta["round"] != len(trainer.result.sim_time):
        raise SystemExit("the checkpoint did not load back bit for bit")


# -- the dry run and its accounting on the card (phase 27) ---------------------

# (a): the one pair run in a spawned worker, as the sweep runs each of its
# 40 (`python -m repro_torch.launch.dryrun --arch all --shape all`, a CPU
# job: the tests and the README run it).
SWEEP_ARCH, SWEEP_SHAPE = "qwen2-0.5b", "train_4k"
# (b): the pair whose accounting the card checks, on a (1, 1) mesh: the
# whole pair on one device (1.98 GB of float32 params, a 51.5 GB bf16 KV
# cache, 128 int32 tokens).
ACCOUNT_ARCH, ACCOUNT_SHAPE, ACCOUNT_STEPS = "qwen2-0.5b", "decode_32k", 3
ACCOUNT_BYTES_RTOL = 0.01
# A time below its bound by more than this (share of the bound above it)
# means a count or a constant is wrong.
SHARE_LIMIT = 1.05


def start_dryrun_pair():
    """27 (a)'s pair (SWEEP_ARCH SWEEP_SHAPE on the single mesh), started
    in one spawned worker, as `launch/dryrun.py`'s sweep runs each pair:
    (executor, future, start time). It is host work on a core the card
    phases leave idle, so it starts before phases 25-26 (device-bound) and
    phase 27 reads it."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor
    from repro_torch.launch import dryrun
    ex = ProcessPoolExecutor(max_workers=1,
                             mp_context=multiprocessing.get_context("spawn"))
    return ex, ex.submit(dryrun.run_pair, SWEEP_ARCH, SWEEP_SHAPE, "single",
                         ""), time.perf_counter()


def phase_dryrun_sweep(pending):
    """27 (a): the pair `start_dryrun_pair` started: ok, and its worker did
    not initialise CUDA; then the multipod demo twin's one pair on the
    512-device mesh in this process, whose CUDA allocation must not move.
    The 40-pair sweep is host work (about a minute on the card's 8 host
    cores) that would hold the card idle: the CPU tests and the README's
    command run it."""
    import runpy
    import torch
    ex, future, t0 = pending
    try:
        rec = future.result()
    finally:
        ex.shutdown()
    wall = time.perf_counter() - t0
    print(f"[dryrun] {SWEEP_ARCH} {SWEEP_SHAPE} on the single mesh in a "
          f"spawned worker: ok {rec['ok']}, done {wall:.1f} s after it "
          f"started ({rec['total_seconds']:.1f} s in the worker), worker CUDA "
          f"initialised {rec['cuda_initialized']}; {rec.get('aggregation')} "
          f"plan {rec.get('collectives', {}).get('count')} collectives, "
          f"{rec.get('collectives', {}).get('total_wire_bytes', 0):.4g} wire "
          f"B a device; counted FLOPs over analytic "
          f"{rec.get('flops_vs_analytic', float('nan')):.4f} (as run "
          f"{rec.get('flops_vs_analytic_as_run', float('nan')):.4f})",
          flush=True)
    if not rec["ok"] or rec["cuda_initialized"]:
        raise SystemExit(f"the dry-run pair failed: {rec.get('error')}, "
                         f"worker CUDA {rec['cuda_initialized']}")
    before = torch.cuda.memory_allocated()
    demo = runpy.run_path(str(Path(__file__).resolve().parent / "examples"
                              / "multipod_dryrun_demo_torch.py"),
                          run_name="multipod_demo")
    t0 = time.perf_counter()
    rc = demo["main"]([])
    print(f"[dryrun] multipod demo twin (gemma-7b train_4k, 2x16x16): rc "
          f"{rc}, {time.perf_counter() - t0:.1f} s; CUDA memory allocated "
          f"{torch.cuda.memory_allocated()} B", flush=True)
    if rc or torch.cuda.memory_allocated() != before:
        raise SystemExit("the multipod demo twin failed")


def phase_dryrun_accounting(card):
    """27 (b): the dry run's per-device argument bytes for qwen2-0.5b
    decode_32k on a (1, 1) mesh against the card's allocation for the
    same params, cache and tokens; three decode steps, CUDA events, against
    max(counted FLOPs / PEAK_FLOPS, argument bytes / HBM_BW)."""
    import torch
    from repro_torch.configs.base import INPUT_SHAPES
    from repro_torch.configs.registry import get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import transformer as tfm
    from repro_torch.utils import flops as fl
    rec = dryrun.run_pair(ACCOUNT_ARCH, ACCOUNT_SHAPE, "single", "",
                          mesh=make_test_mesh((1, 1)))
    if not rec["ok"]:
        raise SystemExit(f"dry run of {ACCOUNT_ARCH} failed: {rec['error']}")
    arg, flops = rec["memory"]["argument_bytes"], rec["flops_global"]
    cfg, shape = get_config(ACCOUNT_ARCH), INPUT_SHAPES[ACCOUNT_SHAPE]
    B = shape.global_batch
    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    params = tfm.init_params(cfg, torch.Generator(device="cuda"
                                                  ).manual_seed(0))
    cache = tfm.init_cache(cfg, B, shape.seq_len)
    tok = torch.zeros((B, 1), dtype=torch.int32, device="cuda")
    torch.cuda.synchronize()
    grown = torch.cuda.memory_allocated() - base
    gap = abs(grown - arg) / arg
    print(f"[account] {ACCOUNT_ARCH} {ACCOUNT_SHAPE} on a (1, 1) mesh: dry "
          f"run argument bytes {arg:,}, the card's allocation grew "
          f"{grown:,} B ({gap:.3%} apart; tol {ACCOUNT_BYTES_RTOL:.0%})",
          flush=True)
    if not gap <= ACCOUNT_BYTES_RTOL:
        raise SystemExit("the dry run's argument bytes disagree with the "
                         "card's allocation")
    torch.cuda.reset_peak_memory_stats()
    tfm.decode_step(cfg, params, cache, tok)  # warm-up: cuBLAS, allocator
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(ACCOUNT_STEPS):
        tfm.decode_step(cfg, params, cache, tok)
    end.record()
    end.synchronize()
    step_s = start.elapsed_time(end) / ACCOUNT_STEPS / 1e3
    t_ops, t_bytes = flops / fl.PEAK_FLOPS, arg / fl.HBM_BW
    bound = max(t_ops, t_bytes)
    share = bound / step_s
    print(f"[account] decode step {step_s * 1e3:.3f} ms (CUDA events, "
          f"{ACCOUNT_STEPS} steps, B={B} against a {shape.seq_len}-slot "
          f"cache); bound {bound * 1e3:.3f} ms (counted {flops:.4g} FLOPs "
          f"at {fl.PEAK_FLOPS:.4g}/s: {t_ops * 1e3:.4f} ms; {arg:,} B at "
          f"{fl.HBM_BW:.4g} B/s: {t_bytes * 1e3:.3f} ms), share of bound "
          f"{share:.4f} (limit {SHARE_LIMIT}); peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; {card}",
          flush=True)
    traffic = rec["bytes_per_device"]
    print(f"[account] the dry run's counted (eager, unfused) traffic "
          f"{traffic:.4g} B takes {traffic / fl.HBM_BW * 1e3:.3f} ms at "
          f"HBM_BW: {traffic / fl.HBM_BW / step_s:.4f} of the step",
          flush=True)
    if not share <= SHARE_LIMIT:
        raise SystemExit("a decode step beat its bound: a count or a "
                         "constant is wrong")
    del params, cache


def phase_dryrun_peak_share(prefill_times, card):
    """27 (c): each served arch's prefill (phases 6, 8, 13, 15, 22, 25;
    B = 4, S = 2048, not run again): model FLOPs, counted and analytic
    FLOPs at that shape, and model FLOPs / (prefill s x PEAK_FLOPS)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.configs.base import InputShape, MeshConfig
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.utils import flops as fl
    from repro_torch.utils.analytic import (analytic_costs,
                                            analytic_flops_as_run)
    mc, one = MeshConfig(), make_test_mesh((1, 1))
    for arch, (cfg, B, S, prefill_s) in prefill_times.items():
        shape = InputShape("serve", S, B, "prefill")
        with FakeTensorMode():
            counted = dryrun.lower_prefill(cfg, shape, one, mc).flops_global
        model = fl.model_flops(cfg, shape)
        ana = analytic_costs(cfg, shape, mc)["flops_global"]
        as_run = analytic_flops_as_run(cfg, shape, mc)
        peak = prefill_s * fl.PEAK_FLOPS
        share = model / peak
        print(f"[peak] {arch} ({cfg.n_layers} layers) prefill {B}x{S}: "
              f"{prefill_s:.4f} s; model FLOPs {model:.4g}, counted "
              f"{counted:.4g} (as-run analytic {as_run:.4g}, ratio "
              f"{counted / as_run:.4f}), analytic_costs {ana:.4g}; share of "
              f"peak {share:.4f} (model), {counted / peak:.4f} (counted); "
              f"{card}", flush=True)
        if not share <= SHARE_LIMIT:
            raise SystemExit(f"{arch}'s prefill beat the card's peak: a "
                             f"count or a constant is wrong")


# -- shard_clients across ranks (phase 28) ---------------------------------------

# The ranks of (b)-(c): two gloo processes sharing the one card.
SHARD_WORLD = 2
SHARD_ROUNDS = 3
SHARD_SEEDS = (0, 1)
# (b)'s sampled run: K = 50 lanes of M = 10,000 clients, 25 lanes a rank.
SHARD_M, SHARD_K = 10_000, 50
# (d): timed chunks of 3 rounds after (a)-(b)'s runs, and collective calls.
SHARD_TIMED_CHUNKS = 4
SHARD_COLLECTIVE_CALLS = 20


def shard_specs():
    """(uncompressed mnist_paper, mnist_sampled at K = 50 of M = 10,000),
    both with shard_clients=True."""
    from repro_torch.federated import experiment
    from repro_torch.federated.experiment import CohortSpec, PopulationSpec
    paper = experiment.get("mnist_paper").replace(shard_clients=True)
    sampled = experiment.get("mnist_sampled").replace(
        population=PopulationSpec(M=SHARD_M, cohort=CohortSpec(K=SHARD_K)),
        shard_clients=True)
    return paper, sampled


def _summary(res):
    """A SimResult as host values: (records, losses, test accs, params)."""
    from repro_torch.utils.tree import leaves
    return (_records(res), [r.train_loss for r in res.history],
            [r.test_acc for r in res.history],
            [x.detach().cpu().clone() for x in leaves(res.params)])


def _shard_gaps(got, want):
    """(records exact, max relative loss gap, max param gap, bit-equal)."""
    loss = max(abs(a - b) / abs(b) for a, b in zip(got[1], want[1]))
    param = max(float((x - y).abs().max()) for x, y in zip(got[3], want[3]))
    same = loss == 0 and got[2] == want[2] and all(
        bool((x == y).all()) for x, y in zip(got[3], want[3]))
    return got[0] == want[0], loss, param, same


def _sync(device):
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _steady_s(sim, state):
    """Median s/round of SHARD_TIMED_CHUNKS chunks of 3 rounds (no eval),
    after one chunk of warm-up."""
    state, _ = sim.run_chunk(state, 3)
    per_round = []
    for _ in range(SHARD_TIMED_CHUNKS):
        t0 = time.perf_counter()
        state, _ = sim.run_chunk(state, 3)
        _sync(sim.device)
        per_round.append((time.perf_counter() - t0) / 3)
    return statistics.median(per_round)


def _n_params(sim):
    from repro_torch.utils.tree import leaves
    return sum(x.numel() for x in leaves(sim._init_params))


def _collective_ms(n_params, device):
    """ms of one round's sum_partials: an all_reduce of n_params float32
    on `device` (host clock around synchronised calls)."""
    import torch
    from repro_torch.sharding import collectives
    buf = torch.randn(n_params, device=device)
    collectives.sum_partials([buf])
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(SHARD_COLLECTIVE_CALLS):
        collectives.sum_partials([buf])
    _sync(device)
    return (time.perf_counter() - t0) / SHARD_COLLECTIVE_CALLS * 1e3


def _int8_shardmap_round(sim):
    """(c): one round of `sim`'s clients through 'int8_shardmap' on this
    rank's lanes against 'allreduce' over all of them, from the same
    batches: (max gap, the largest client delta's quantizer step, the
    dtypes the round gathered). Also the reference test's quadratic round
    (C = 4, V = 3; its bound 2/127): (its gap, dtypes)."""
    import torch
    from repro_torch.federated import client, mesh_rounds
    from repro_torch.federated.simulation import _upload
    from repro_torch.optim.sgd import sgd
    from repro_torch.sharding import collectives
    from repro_torch.utils.tree import leaves, tree_map
    dtypes, gather = [], collectives.gather_rows

    def recording(x, dim=0, group=None):
        dtypes.append(x.dtype)
        return gather(x, dim, group)

    def one_round(vg, opt, params, batches, weights):
        lanes = collectives.lane_slice(weights.shape[0])
        plain = mesh_rounds.build_round_step(vg, opt, "allreduce")
        want = plain(params, opt.init(params), batches, weights)
        step = mesh_rounds.build_round_step(vg, opt, "int8_shardmap")
        local = tree_map(lambda x: x[lanes], params)
        dtypes.clear()
        mesh_rounds.collectives.gather_rows = recording
        try:
            got = step(local, opt.init(local),
                       tree_map(lambda x: x[lanes], batches), weights)
        finally:
            mesh_rounds.collectives.gather_rows = gather
        gap = max(float((g - w[lanes]).abs().max())
                  for g, w in zip(leaves(got[0]), leaves(want[0])))
        return gap, list(dtypes)

    C, V = sim._lanes, sim.fed.local_rounds
    params = mesh_rounds.replicate_clients(sim._init_params, C)
    iters = sim._make_iters(0)
    batches = tree_map(lambda x: _upload(x, sim.device),
                       client.stack_client_batches(iters, V))
    local = mesh_rounds.local_steps_fn(sim.value_and_grad, sim.opt)
    new = local(params, sim.opt.init(params), batches)[0]
    step = max(float((n - o).abs().max()) for n, o in
               zip(leaves(new), leaves(params))) / 127
    cnn_gap, cnn_dtypes = one_round(sim.value_and_grad, sim.opt, params,
                                    batches, sim._weights)

    def quad(p, batch):
        diff = p["w"] - batch["target"]
        return 0.5 * torch.sum(diff * diff)

    qp = mesh_rounds.replicate_clients(
        {"w": torch.ones(8, device=sim.device)}, 4)
    target = torch.stack([torch.full((3, 8), float(t), device=sim.device)
                          for t in range(4)])
    q_gap, _ = one_round(mesh_rounds.vmapped_value_and_grad(quad), sgd(0.05),
                         qp, {"target": target},
                         torch.full((4,), 0.25, device=sim.device))
    return cnn_gap, step, cnn_dtypes, q_gap


def _shard_rank(rank, rdzv, out, device, specs):
    """One of (b)'s two gloo ranks on `device`, the one card
    (torch.multiprocessing.spawn runs it): the sharded runs of `specs`
    (shard_specs()), their fold launches, (c) and (d)'s times, pickled to
    `out`."""
    import torch
    import torch.distributed as dist
    from repro_torch.kernels.fold_matmul import ops as fm_ops
    from repro_torch.kernels.quantize import ops as q_ops
    if device == "cuda":
        torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{rdzv}", rank=rank,
                            world_size=SHARD_WORLD)
    paper, sampled = specs
    res = {}
    q_ops.launches = fm_ops.launches = 0
    sim = paper.build(device=device)
    res["lanes"] = (sim._shard, sim._lanes_local, str(sim.device))
    state, r = sim.run(sim.init(), max_rounds=SHARD_ROUNDS,
                       eval_every=SHARD_ROUNDS)
    res["paper"] = _summary(r)
    fleet = sim.run_fleet(seeds=SHARD_SEEDS, max_rounds=SHARD_ROUNDS,
                          eval_every=SHARD_ROUNDS)
    res["fleet"] = [_summary(m) for m in fleet.results]
    ssim = sampled.build(device=device)
    res["sampled_lanes"] = ssim._lanes_local
    _, r = ssim.run(ssim.init(), max_rounds=SHARD_ROUNDS,
                    eval_every=SHARD_ROUNDS)
    res["sampled"] = _summary(r)
    res["launches"] = {"fold_matmul": fm_ops.launches,
                       "quantize": q_ops.launches}
    res["s_per_round"] = _steady_s(sim, state)
    res["collective_ms"] = _collective_ms(_n_params(sim), sim.device)
    res["int8"] = _int8_shardmap_round(sim)
    with open(Path(out) / f"rank{rank}.pkl", "wb") as f:
        pickle.dump(res, f)
    dist.destroy_process_group()


def phase_shard_nccl(counters, card, device="cuda", backend="nccl"):
    """28 (a): uncompressed mnist_paper with shard_clients=True in an NCCL
    group of one rank (a HashStore), 3 rounds: records and params bit-equal
    to the unsharded run's, the fold matmul launched and no other kernel;
    then both runs' steady s/round and the all_reduce's ms a round.
    Returns (launches, the unsharded run's summary and s/round)."""
    import torch.distributed as dist
    paper, _ = shard_specs()
    plain = _on_card(paper.replace(shard_clients=False).build(device=device),
                     "28 (a)")
    state, res = plain.run(plain.init(), max_rounds=SHARD_ROUNDS,
                           eval_every=SHARD_ROUNDS)
    want, plain_s = _summary(res), _steady_s(plain, state)
    dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        sim = _on_card(paper.build(device=device), "28 (a)")
        (state, res), launches = _launched(counters, lambda: sim.run(
            sim.init(), max_rounds=SHARD_ROUNDS, eval_every=SHARD_ROUNDS))
        got, shard_s = _summary(res), _steady_s(sim, state)
        coll = _collective_ms(_n_params(sim), sim.device)
        lanes = (sim._shard, sim._lanes_local, str(sim.device))
    finally:
        dist.destroy_process_group()
    exact, loss, param, same = _shard_gaps(got, want)
    print(f"[shard] (a) mnist_paper uncompressed (plan b*="
          f"{sim.fed.batch_size}, V={sim.fed.local_rounds}), shard_clients in "
          f"a {backend} group of one rank (sharded, lanes, device {lanes}), "
          f"{SHARD_ROUNDS} rounds: "
          f"records exact {exact}, loss gap {loss:.3g}, param gap "
          f"{param:.3g}, bit-equal to the unsharded run {same}; launches "
          f"{launches}", flush=True)
    print(f"[shard] (d) steady state on {card}: unsharded {plain_s!r} s per "
          f"round, {backend} world of one {shard_s!r} s per round; its "
          f"all_reduce "
          f"of {_n_params(sim):,} float32 {coll:.4f} ms a round "
          f"({SHARD_TIMED_CHUNKS} chunks of 3, no eval; "
          f"{SHARD_COLLECTIVE_CALLS} calls)", flush=True)
    _check_uncompressed("shard", launches)
    if not (lanes[0] and same):
        raise SystemExit("28 (a): a world of one is not the unsharded run")
    return launches, want, plain_s


def phase_shard_gloo(counters, card, want_paper, plain_s, device="cuda"):
    """28 (b)-(d): two gloo ranks spawned on the one card, each with 5 of
    mnist_paper's lanes (3 rounds, then a 2-seed fleet) and 25 of
    mnist_sampled's 50 (M = 10,000): records exact and params within 1e-5 /
    5e-4 of the unsharded runs' on this card, the ranks bit-equal, the
    fold matmul launched on each rank and nothing else; (c)
    'int8_shardmap' across the ranks with CUDA tensors: int8 on the wire,
    within one quantizer step of the largest client delta of 'allreduce'
    at mnist_paper's width and within 2/127 on the reference test's
    round; (d) a rank's s/round and all_reduce ms. Returns the ranks'
    launches."""
    import tempfile
    import torch.multiprocessing as mp
    paper, sampled = shard_specs()
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        ctx = mp.start_processes(_shard_rank, args=(
            f"{tmp}/rdzv", tmp, device, (paper, sampled)),
            nprocs=SHARD_WORLD, join=False, start_method="spawn")
        # The unsharded runs, while the ranks start up and reach the card.
        psim = _on_card(paper.replace(shard_clients=False).build(
            device=device), "28 (b)")
        fleet = psim.run_fleet(seeds=SHARD_SEEDS, max_rounds=SHARD_ROUNDS,
                               eval_every=SHARD_ROUNDS)
        ssim = _on_card(sampled.replace(shard_clients=False).build(
            device=device), "28 (b)")
        want = {"paper": want_paper,
                "fleet": [_summary(m) for m in fleet.results],
                "sampled": _summary(ssim.run(
                    ssim.init(), max_rounds=SHARD_ROUNDS,
                    eval_every=SHARD_ROUNDS)[1])}
        while not ctx.join():
            pass
        wall = time.perf_counter() - t0
        ranks = []
        for r in range(SHARD_WORLD):
            with open(Path(tmp) / f"rank{r}.pkl", "rb") as f:
                ranks.append(pickle.load(f))
    print(f"[shard] (b) {SHARD_WORLD} gloo ranks on one card: {wall:.1f} s "
          f"wall (spawn and this process's unsharded runs included); lanes {[r['lanes'] for r in ranks]}, "
          f"sampled lanes {[r['sampled_lanes'] for r in ranks]}; launches "
          f"{[r['launches'] for r in ranks]}", flush=True)
    lanes = (paper.fed.n_devices // SHARD_WORLD,
             sampled.cohort_spec().K // SHARD_WORLD)
    ok = all(r["lanes"][:2] == (True, lanes[0])
             and r["sampled_lanes"] == lanes[1]
             and r["launches"]["fold_matmul"] > 0
             and not r["launches"]["quantize"] for r in ranks)
    runs = [("paper", ranks[0]["paper"], ranks[1]["paper"], want["paper"])]
    runs += [(f"fleet seed {s}", a, b, w) for s, a, b, w in zip(
        SHARD_SEEDS, ranks[0]["fleet"], ranks[1]["fleet"], want["fleet"])]
    runs.append(("sampled", ranks[0]["sampled"], ranks[1]["sampled"],
                 want["sampled"]))
    for name, a, b, w in runs:
        same_ranks = _shard_gaps(a, b)[3]
        exact, loss, param, same = _shard_gaps(a, w)
        print(f"[shard] (b) {name}: ranks bit-equal {same_ranks}; against "
              f"the unsharded run records exact {exact}, loss gap "
              f"{loss:.3g} (tol {FLEET_LOSS_RTOL:g}), param gap {param:.3g} "
              f"(tol {FLEET_PARAM_ATOL:g}), bit-equal {same}", flush=True)
        ok = ok and same_ranks and exact and loss <= FLEET_LOSS_RTOL \
            and param <= FLEET_PARAM_ATOL
    for r, res in enumerate(ranks):
        cnn_gap, step, dtypes, q_gap = res["int8"]
        print(f"[shard] (c) rank {r} int8_shardmap: mnist_paper's round "
              f"{cnn_gap:.3g} from allreduce (one quantizer step of the "
              f"largest client delta {step:.3g}); the reference test's round "
              f"{q_gap:.3g} (tol {2 / 127:.4g}); gathered dtypes "
              f"{sorted(set(str(d) for d in dtypes))}", flush=True)
        ok = ok and cnn_gap <= step and q_gap <= 2 / 127 + 1e-6 \
            and "torch.int8" in {str(d) for d in dtypes}
    print(f"[shard] (d) steady state on {card}: unsharded {plain_s!r} s per "
          f"round; a gloo rank's {[r['s_per_round'] for r in ranks]!r} s per "
          f"round; its all_reduce of {_n_params(psim):,} float32 through "
          f"gloo {[round(r['collective_ms'], 4) for r in ranks]} ms a round",
          flush=True)
    if not ok:
        raise SystemExit("28 (b)-(c): a sharded run broke its contract")
    launches = {k: 0 for k in counters}
    launches["fold_matmul"] = sum(r["launches"]["fold_matmul"]
                                  for r in ranks)
    return launches


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false: this script "
              "needs an NVIDIA card", file=sys.stderr)
        return 1
    from repro_torch.device import resolve_device
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.fold_matmul import ops as fm_ops
    from repro_torch.kernels.quantize import ops as q_ops
    from repro_torch.kernels.selective_scan import ops as ss_ops
    counters = {"quantize": q_ops, "flash_attention": fa_ops,
                "selective_scan": ss_ops, "fold_matmul": fm_ops}

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
    phase_fold_spills(logs["fold_matmul"])
    phase_flash_spills(logs["flash_attention"])
    phase_flash_sass()

    # -- 3. kernels against their plain versions -----------------------------
    records = {"quantize": phase_quantize_kernel(dev, card),
               "flash_attention": phase_flash_kernel(dev, card),
               "selective_scan": phase_scan_kernel(dev, card),
               "fold_matmul": phase_fold_matmul_kernel(dev, card)}

    # -- 4, 5. the FL path and its reference ---------------------------------
    paper = phase_fl_main_path(counters, card=card)
    fl_launches = [paper["launches"]]
    phase_fl_reference(counters)

    # -- 10, 11. cifar_paper; the fleet and the quickstart twin --------------
    fl_launches.append(phase_fl_main_path(counters, "cifar_paper", "cifar",
                                          card)["launches"])
    fl_launches.append(phase_fl_fleet(counters))
    fl_launches.append(phase_quickstart(counters))

    # -- 12. edge scenarios, faults and resilience ---------------------------
    phase_storm_quantize(dev, card)
    fl_launches.append(phase_storm(counters, card, paper))
    fl_launches.append(phase_quorum(counters, card))
    fl_launches.append(phase_guard(counters, card))
    fl_launches.append(phase_dropout_fleet(counters, card))

    # -- 18. the per-round backends: loop, batched, run_round, checkpoints ---
    launches, loop_bits = phase_backends(counters, card, paper)
    fl_launches.extend(launches)
    fl_launches.extend(phase_backends_uncompressed(counters))
    fl_launches.extend(phase_backends_checkpoint(counters))
    fl_launches.append(phase_backends_cost(counters, card, paper))
    print(f"[backends] compressed loop params bit for bit against batched: "
          f"{loop_bits}", flush=True)

    # -- 19. sampled participation: K-client cohorts of M clients ------------
    fl_launches.extend(phase_sampled_dense(counters, paper))
    launches, scale, dense = phase_sampled_scale(counters, card)
    fl_launches.extend(launches)
    fl_launches.append(phase_sampled_spare(counters))
    fl_launches.append(phase_sampled_fleet(counters, card))
    fl_launches.append(phase_sampled_reference(counters))
    fl_launches.append(phase_sampled_cost(counters, card, scale, dense))
    del scale, dense

    # -- 20. the asynchronous backend: the event queue --------------------------
    launches, paper_async = phase_async(counters, card)
    fl_launches.append(launches)
    fl_launches.append(phase_async_checkpoint(counters))
    fl_launches.append(phase_async_sync_limit(counters))
    fl_launches.append(phase_async_reference(counters))
    fl_launches.extend(phase_async_fedasync(counters))
    phase_async_no_sync(paper_async)
    fl_launches.extend(phase_async_cost(counters, card, paper))
    del paper_async

    # -- 21. trace-driven fleets and the online planner --------------------------
    t21 = time.perf_counter()
    launches, straight = phase_trace(counters, card)
    fl_launches.append(launches)
    fl_launches.append(phase_trace_checkpoint(counters, straight))
    fl_launches.extend(phase_trace_replay(counters, card))
    fl_launches.append(phase_trace_reference(counters))
    phase_planner_demo()
    fl_launches.append(phase_trace_cost(counters, card, paper, straight))
    del straight
    print(f"[trace] phase 21 took {time.perf_counter() - t21:.1f} s",
          flush=True)

    # -- 17. the Study: DEFL vs FedAvg vs Rand -------------------------------
    fig2, fig2_launches = phase_fig2(counters, card)
    fl_launches.extend(fig2_launches)
    study_launches, study_rows = phase_study_compressed(
        counters, card, fig2["mnist"][0])
    fl_launches.append(study_launches)
    phase_study_quantize(dev, card, study_rows)
    fl_launches.append(phase_bit_check(counters, card, *fig2["mnist"][:2]))
    phase_study_cost(card, fig2)
    del fig2
    gc.collect()
    torch.cuda.empty_cache()

    # -- 28. shard_clients across ranks: NCCL at world 1, two gloo ranks ------
    t28 = time.perf_counter()
    launches, want_paper, plain_s = phase_shard_nccl(counters, card)
    fl_launches.append(launches)
    fl_launches.append(phase_shard_gloo(counters, card, want_paper, plain_s))
    print(f"[shard] phase 28 took {time.perf_counter() - t28:.1f} s",
          flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    for launches in fl_launches:
        others = {k: n for k, n in launches.items()
                  if k not in FL_KERNELS and n}
        if others or not launches["fold_matmul"]:
            raise SystemExit(f"the FL path launched other kernels, or not "
                             f"the fold matmul: {launches}")

    # -- 6, 7. qwen2-0.5b serving and its reference --------------------------
    prefill_times = {}
    qwen2_launches = phase_serve(counters, "qwen2-0.5b", prefill_times)
    phase_serve_reference("qwen2-0.5b")
    # Free qwen2's weights and caches before the 28 GB of falcon-mamba-7b.
    gc.collect()
    torch.cuda.empty_cache()

    # -- 8, 9. falcon-mamba-7b serving and its reference ---------------------
    falcon_launches = phase_serve(counters, "falcon-mamba-7b",
                                  prefill_times)
    gc.collect()
    torch.cuda.empty_cache()
    phase_serve_reference("falcon-mamba-7b")

    # -- 13-16. gemma-7b and zamba2-2.7b serving and their references --------
    # Each serve phase's weights and caches are freed before the next.
    attn_launches = [qwen2_launches]
    for arch in ("gemma-7b", "zamba2-2.7b"):
        attn_launches.append(phase_serve(counters, arch, prefill_times))
        gc.collect()
        torch.cuda.empty_cache()
        phase_serve_reference(arch)

    # -- 22, 23. musicgen-large serving and its reference ---------------------
    attn_launches.append(phase_serve(counters, "musicgen-large",
                                     prefill_times))
    gc.collect()
    torch.cuda.empty_cache()
    phase_serve_reference("musicgen-large")

    # -- 24. training: train.py at qwen2-0.5b's width, card vs CPU, grads,
    # checkpoint ---------------------------------------------------------------
    t24 = time.perf_counter()
    train_launches, trainer = phase_train(counters, card, dev)
    attn_launches.append(train_launches)
    train_fold = train_launches["fold_matmul"]
    phase_train_grads(counters, trainer, dev)
    phase_train_checkpoint(trainer)
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    phase_train_reference(counters, dev)
    attn_launches.append(phase_train_moe(counters, dev))
    scan_launches = [falcon_launches, phase_train_scan(counters, dev)]
    print(f"[train] phase 24 took {time.perf_counter() - t24:.1f} s",
          flush=True)
    gc.collect()
    torch.cuda.empty_cache()

    # -- 25, 26. qwen3-moe-30b-a3b serving (16 of 48 layers); the five
    # archs of the MoE family at smoke size, card vs CPU -----------------------
    t25 = time.perf_counter()
    dryrun_pair = start_dryrun_pair()
    attn_launches.append(phase_serve(counters, "qwen3-moe-30b-a3b",
                                     prefill_times))
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[serve] phase 25 took {time.perf_counter() - t25:.1f} s",
          flush=True)
    t26 = time.perf_counter()
    n26 = sum(phase_serve_reference(arch) for arch in MOE_FAMILY)
    attn_launches.append({"flash_attention": n26})
    print(f"[reference] phase 26 took {time.perf_counter() - t26:.1f} s, "
          f"{n26} flash launches on the card", flush=True)

    # -- 27. the dry run: the sweep, its accounting against the card, the
    # served archs' share of peak --------------------------------------------
    gc.collect()
    torch.cuda.empty_cache()
    t27 = time.perf_counter()
    phase_dryrun_sweep(dryrun_pair)
    phase_dryrun_accounting(card)
    gc.collect()
    torch.cuda.empty_cache()
    phase_dryrun_peak_share(prefill_times, card)
    print(f"[dryrun] phase 27 took {time.perf_counter() - t27:.1f} s",
          flush=True)

    records["quantize"]["launches"] = sum(n["quantize"] for n in fl_launches)
    records["flash_attention"]["launches"] = sum(
        n["flash_attention"] for n in attn_launches)
    records["selective_scan"]["launches"] = sum(
        n["selective_scan"] for n in scan_launches)
    records["fold_matmul"]["launches"] = sum(
        n["fold_matmul"] for n in fl_launches) + train_fold
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
