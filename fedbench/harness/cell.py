"""One run of one cell: set-up (the program built from the seed and driven
through its first rounds by the window's own call, which also warms it),
the measured window, the traced window's reduction, and the comparison
with the plain reference that decides `correct`.

The comparison follows the first `check_rounds` rounds of every member,
as the training bullet of the benchmark's contract reads for a federated
round: each round's train loss, read from the records of the calls that
ran it, and the change of the global model after each call (after the
first round where a call ends there, and after the last), each leaf's
norm against the reference's (the worst leaf and the median leaf,
measured against the larger of that leaf's reference norm and the median
leaf's; leaves whose reference change is under a thousandth of the
median leaf's are left out) and the norm of the whole change. The plan
and every Eq. 8 record of every round the run made, the window's
included, are compared exactly with the reference's float64 clock.
"""
from __future__ import annotations

import gc
import math
import statistics
import time

import torch

from fedbench.harness import manifest, trace as tracing, yardstick
from fedbench.reference.rounds import Trace, norms

# Leaves whose reference change is under this share of the median leaf's
# move by round-off alone and are not compared.
STILL_LEAF = 1e-3
# The numbers every cell compares exactly; a cell's limits file adds the
# readings it compares (`readings`).
EXACT = ("plan_mismatch", "record_mismatch", "nonfinite_loss")


def leaf_gaps(prog: dict, ref: dict) -> dict:
    """Each compared leaf's gap of norms, against the larger of its
    reference norm and the median leaf's."""
    med = statistics.median(ref.values())
    return {k: abs(prog[k] - r) / max(r, med) for k, r in ref.items()
            if r >= STILL_LEAF * med}


def total_gap(prog: dict, ref: dict) -> float:
    """The gap of the whole change's norm, against the reference's."""
    p = math.sqrt(sum(v * v for v in prog.values()))
    r = math.sqrt(sum(v * v for v in ref.values()))
    return abs(p - r) / r


def member_readings(run, ref) -> dict:
    """One member's numbers against the reference's: the loss gap of each
    round and the worst of them, and after the first round (where a call
    ended there) and after the last the worst leaf's, the median leaf's
    and the whole change's gap."""
    out = {}
    for r, (a, b) in enumerate(zip(run.losses, ref.losses)):
        out[f"loss_gap_r{r + 1}"] = (abs(a - b) / abs(b) if math.isfinite(a)
                                     else math.inf)
    out["loss_gap"] = max(out.values())
    for step, r in (("step1", 1), ("stepn", max(run.changes))):
        if r not in run.changes:
            continue
        prog, want = run.changes[r], ref.changes[r]
        gaps = leaf_gaps(prog, want)
        out[f"{step}_gap"] = max(gaps.values())
        out[f"{step}_median_gap"] = statistics.median(gaps.values())
        out[f"{step}_total_gap"] = total_gap(prog, want)
    return out


def readings(runs: list, ref: list, members: list) -> dict:
    """The numbers that compare followed runs [Trace] with the
    reference's, each the worst over the members and, where the members
    come from several arms, the worst over each arm's, prefixed
    "<label>.": a Study's arms of 15 to 30 local steps carry float32
    rounding far into their first round's loss and leaves, one of a
    single step carries none (PERF.md). Each number's median over the
    members, prefixed "member_median.", is steady where a max-pool or
    ReLU tie that rounding decides carries one member of a fleet far
    from the rest, as the reference moved by one ulp does on the same
    seeds (PERF.md)."""
    each = [member_readings(p, q) for p, q in zip(runs, ref)]

    def worst(ms, prefix=""):
        return {f"{prefix}{k}": max(m[k] for m in ms) for k in ms[0]}

    out = worst(each)
    out.update({f"member_median.{k}": statistics.median(m[k] for m in each)
                for k in each[0]})
    labels = [m.label for m in members]
    if len(set(labels)) > 1:
        for label in dict.fromkeys(labels):
            out.update(worst([m for m, x in zip(each, labels) if x == label],
                             f"{label}."))
    return out


def first_rounds(run, init: dict, traffic: dict) -> list:
    """Drive `run` through its first `check_rounds` rounds by the window's
    own call (`rounds_per_call` rounds, an eval every `eval_every`), the
    global model's change read after each call: [Trace] of its
    members."""
    rounds, rpc = traffic["check_rounds"], traffic["rounds_per_call"]
    if rounds % rpc:
        raise SystemExit("check_rounds is not a whole number of calls")
    changes = [{} for _ in range(run.n)]
    for done in range(rpc, rounds + 1, rpc):
        run.advance(rpc, traffic["eval_every"])
        for i in range(run.n):
            changes[i][done] = _change(run.params(i), init)
    return [Trace(losses=[float(r.train_loss) for r in run.hist[i]],
                  changes=changes[i])
            for i in range(run.n)]


def _change(params: dict, init: dict) -> dict:
    return norms({k: params[k] - init[k] for k in init})


def reference(kind, cfg, traffic, seed, init, device, mode=None,
              half_batch=False, mean_over_envelope=False):
    """The reference's members and their followed rounds, run by the
    configuration's model family: at the configuration's precision, or
    `mode` (the family's CONTROL); the last two plant faults, the second
    dividing each member's batch loss by the largest b of the members."""
    members, data = kind.reference_members(cfg, traffic, seed)
    mean_over = max(m.b for m in members) if mean_over_envelope else None
    runs = manifest.family(cfg["family"]).reference(
        cfg, members, data, init, device, traffic["check_rounds"], mode,
        half_batch, mean_over)
    return members, runs


def record_mismatches(run_hist: list, members: list) -> int:
    bad = 0
    for hist, m in zip(run_hist, members):
        expected = m.records(len(hist))
        for rec, exp in zip(hist, expected):
            got = (rec.round, rec.sim_time, rec.T_cm, rec.T_cp,
                   rec.uplink_bits, rec.n_participants)
            bad += got != exp
    return bad


def seed_base(seed: int) -> int:
    """The seed the data, partition, population and model are drawn at;
    run seeds follow it. Kept under 2**31 so every generator takes it."""
    return int(seed) % (2 ** 31)


def run_cell(cell: str, seed: int, seconds: float, trace: bool,
             device: torch.device, t_start: float, bench=None,
             cfg=None, traffic=None, limits=None) -> dict:
    """One run of `cell`; returns the result line's fields. `cfg`,
    `traffic` and `limits` replace the cell's files (tests run small
    configurations on the CPU)."""
    bench = bench or manifest.benchmark()
    w = manifest.workload(bench, cell)
    cfg = cfg or manifest.config(bench, w["config"])
    traffic = traffic or manifest.traffic(w["traffic"])
    limits = limits or manifest.limits(cell)
    kind = manifest.kind(traffic["kind"])
    family = manifest.family(cfg["family"])
    base = seed_base(seed)
    cuda = device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)

    init = family.init_params(cfg, base, device)
    t = time.perf_counter()
    run = kind.Program(cfg, traffic, base, device, init)
    sync()
    build_s = time.perf_counter() - t
    followed = first_rounds(run, init, traffic)
    sync()
    setup_s = time.perf_counter() - t_start
    parts = {"before_build": t - t_start, "build": build_s,
             "first_rounds": t_start + setup_s - t - build_s}
    rpc, every = traffic["rounds_per_call"], traffic["eval_every"]

    start = len(run.hist[0])
    # A traced window may be shorter than --seconds: the profiler's
    # reduction costs seconds for each second of a window of many launches.
    span = min(seconds, traffic.get("trace_seconds", seconds)) if trace \
        else seconds

    def window():
        done, t0 = 0, time.perf_counter()
        while True:
            done += run.advance(rpc, every)
            now = time.perf_counter()
            if now - t0 >= span:
                return done, now - t0

    if trace:
        (done, window_s), tr = tracing.traced(window)
    else:
        (done, window_s), tr = window(), None
    calls = done // (run.n * rpc)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    extras = run.extras() if trace else {}
    flops, least, qrows = (x * calls for x in run.work(rpc, every))
    plans = run.plans()
    hist = run.hist
    nonfinite = sum(not math.isfinite(r.train_loss)
                    for h in hist for r in h[start:])
    del run
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    members, ref = reference(kind, cfg, traffic, base, init, device)
    checks = readings(followed, ref, members)
    checks["plan_mismatch"] = sum(p != (m.b, m.V)
                                  for p, m in zip(plans, members))
    checks["record_mismatch"] = record_mismatches(hist, members)
    checks["nonfinite_loss"] = nonfinite
    checks = {k: {"value": checks[k], "limit": v}
              for k, v in limits["limits"].items()}
    ctx = {"build_s": build_s, "window_s": window_s, "member_rounds": done,
           "flops": flops, "least_s": least,
           "peak_flops": family.peak_flops(cfg),
           "quantize_bytes": yardstick.quantize_bytes(qrows),
           "trace": tr, **extras}
    return {"correct": all(c["value"] <= c["limit"] for c in checks.values()),
            "attempted": done, "failed": nonfinite,
            "setup_s": setup_s, "setup_parts": parts, "window_s": window_s,
            "peak": peak,
            "ctx": ctx, "checks": checks, "workload": w}


def metrics(bench: dict, result: dict, trace: bool) -> dict:
    """The result line's metrics: the cell's end-to-end metrics, or with
    trace its per-layer metrics, each reader that finds something."""
    cell = result["workload"]["name"]
    if not trace:
        values = {"member_rounds_per_s": result["attempted"]
                  / result["window_s"],
                  "peak_mem_gib": result["peak"] / 2 ** 30,
                  "setup_s": result["setup_s"]}
        return {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                for m in bench["end_to_end"]
                if cell in m.get("workloads", [cell])}
    out = {}
    for m in manifest.per_layer_for(bench, cell):
        value = manifest.metric(m["name"]).read(result["ctx"])
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def limit_lines(checks: dict) -> list:
    return [f"{k} {c['value']!r} limit {c['limit']!r}"
            for k, c in checks.items()]

