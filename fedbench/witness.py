"""Witnesses for a seed whose reading stands far above the rest, on the
card at the cell's own size, in one process:

    python3 fedbench/witness.py --workload <cell> --seeds 3500000391

For every seed, member by member: the program's first rounds against
the reference (as a run compares them), and against the same reference
the reference from the initial model moved one ulp up and one ulp down
and the reference on the host's CPU. Where a witness reads what the
program reads on the same member, or the CPU reference lands where the
program does, the reading is float32 rounding deciding a tie, not a
fault of the program. One JSON line a member.
"""
import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.dirname(HERE), os.path.join(os.path.dirname(HERE),
                                                      "src")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
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
    cpu = torch.device("cpu")
    for seed in (int(s) for s in args.seeds.split(",")):
        base = cell.seed_base(seed)
        init = family.init_params(cfg, base, device)
        run = kind.Program(cfg, traffic, base, device, init)
        followed = cell.first_rounds(run, init, traffic)
        del run
        if device.type == "cuda":
            torch.cuda.empty_cache()
        members, ref = cell.reference(kind, cfg, traffic, base, init, device)
        others = {}
        for tag, to in (("ulp_up", float("inf")), ("ulp_down", float("-inf"))):
            nudged = {k: torch.nextafter(v, torch.full_like(v, to))
                      for k, v in init.items()}
            others[tag] = cell.reference(kind, cfg, traffic, base, nudged,
                                         device)[1]
        others["cpu_ref"] = cell.reference(
            kind, cfg, traffic, base, {k: v.to(cpu) for k, v in init.items()},
            cpu)[1]
        for i, m in enumerate(members):
            row = {"seed": seed, "member": i, "label": m.label,
                   "program": cell.member_readings(followed[i], ref[i])}
            for tag, other in others.items():
                row[tag] = cell.member_readings(other[i], ref[i])
            row["program_vs_cpu"] = cell.member_readings(
                followed[i], others["cpu_ref"][i])
            print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
