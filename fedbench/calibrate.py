"""Readings that a cell's limits are set from, on the card at the cell's own
size, in one process:

    python3 fedbench/calibrate.py --workload <cell> --seeds 1,2,...,12 \
        --controls 4

For every seed, the program's first rounds (the harness's set-up, no
window) against the reference at the configuration's precision: the
lower readings. For the first `--controls` seeds, the control (the
reference in the model family's CONTROL mode, TF32 for the CNN) and the
planted faults of a step that averages half of each batch (the reference
with half its batch) and, where the members' batches differ, of a padded
step whose loss is divided by the largest b instead of its own, each
against the reference: the upper readings; and a witness of rounding
alone: the reference from the initial model moved by one ulp.
A state left unchanged reads 1 on the step gaps and needs no run. One
JSON line a reading, then the largest lower and the least upper reading
of each number.
"""
import argparse
import gc
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.dirname(HERE), os.path.join(os.path.dirname(HERE),
                                                      "src")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--controls", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    import torch
    from fedbench.harness import cell, manifest
    bench = manifest.benchmark()
    w = manifest.workload(bench, args.workload)
    cfg = manifest.config(bench, w["config"])
    traffic = manifest.traffic(w["traffic"])
    kind = manifest.kind(traffic["kind"])
    family = manifest.family(cfg["family"])
    device = torch.device(args.device)
    cuda = device.type == "cuda"
    worst = {}
    least = {}
    for j, seed in enumerate(int(s) for s in args.seeds.split(",")):
        base = cell.seed_base(seed)
        init = family.init_params(cfg, base, device)
        t = time.perf_counter()
        run = kind.Program(cfg, traffic, base, device, init)
        followed = cell.first_rounds(run, init, traffic)
        plans, hist = run.plans(), run.hist
        del run
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        t_prog = time.perf_counter() - t
        t = time.perf_counter()
        members, ref = cell.reference(kind, cfg, traffic, base, init, device)
        t_ref = time.perf_counter() - t
        got = cell.readings(followed, ref, members)
        got["plan_mismatch"] = sum(p != (m.b, m.V)
                                   for p, m in zip(plans, members))
        got["record_mismatch"] = cell.record_mismatches(hist, members)
        print(json.dumps({"seed": seed, "who": "program", **got,
                          "program_s": t_prog, "reference_s": t_ref}),
              flush=True)
        for k, v in got.items():
            worst[k] = max(worst.get(k, 0), v)
        if j < args.controls or len({m.b for m in members}) > 1:
            for m, p, r in zip(members, followed, ref):
                print(json.dumps({"seed": seed, "member": m.label,
                                  "b": m.b, "V": m.V,
                                  "program": p.losses, "reference": r.losses,
                                  **cell.member_readings(p, r)}),
                      flush=True)
        if j >= args.controls:
            continue
        nudged = {k: torch.nextafter(v, torch.full_like(v, float("inf")))
                  for k, v in init.items()}
        runs = [(f"control_{family.CONTROL}", {"mode": family.CONTROL}),
                ("fault_half_batch", {"half_batch": True}),
                ("witness_ulp", {"init": nudged})]
        if len({m.b for m in members}) > 1:
            runs.append(("fault_mean_over_envelope",
                         {"mean_over_envelope": True}))
        for who, kw in runs:
            _, other = cell.reference(kind, cfg, traffic, base,
                                      kw.pop("init", init), device, **kw)
            got = cell.readings(other, ref, members)
            print(json.dumps({"seed": seed, "who": who, "members": [
                {"member": m.label, "V": m.V, **cell.member_readings(p, r)}
                for m, p, r in zip(members, other, ref)]}), flush=True)
            print(json.dumps({"seed": seed, "who": who, **got}), flush=True)
            for k, v in got.items():
                least.setdefault(who, {})
                least[who][k] = min(least[who].get(k, float("inf")), v)
    print(json.dumps({"cell": args.workload, "lower": worst,
                      "upper": least,
                      "card": torch.cuda.get_device_name(0) if cuda
                      else "cpu"}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
