"""Run one cell of the benchmark on the card and print its result line.

    python3 fedbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Set-up (imports, the card, the kernels' libraries, the program's build and
its first rounds) is timed from the start of this process; then the
window's calls run back to back for --seconds; then the plain reference
follows the first rounds and the numbers compared are printed, each
beside its limit, as the last lines of standard error and under "checks",
the last key of the result line: one JSON object, the last line of
standard output. With --trace 1 the window runs under torch.profiler and
the line carries the cell's per-layer metrics instead of its end-to-end
ones.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

from fedbench.harness import imports  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch
    from fedbench.harness import cell, manifest
    bench = manifest.benchmark()
    w = manifest.workload(bench, args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < w["chips"]:
        print(f"fedbench: the cell needs {w['chips']} CUDA card(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    cfg = manifest.config(bench, w["config"])
    diffs = manifest.family(cfg["family"]).registry_differences(cfg)
    if diffs:
        print(f"fedbench: the program's spec no longer runs the "
              f"configuration's file: {diffs}", file=sys.stderr)
        return 3
    device = torch.device("cuda")
    res = cell.run_cell(args.workload, args.seed, args.seconds,
                        bool(args.trace), device, T_START, bench=bench)
    found = imports.forbidden(sys.modules)
    if found:
        print(f"fedbench: forbidden modules loaded: {found}", file=sys.stderr)
        return 4
    line = {"correct": res["correct"], "attempted": res["attempted"],
            "failed": res["failed"],
            "metrics": cell.metrics(bench, res, bool(args.trace)),
            "device": {"platform": "gpu",
                       "kind": torch.cuda.get_device_name(0),
                       "count": w["chips"],
                       "memory_peak_bytes": res["peak"]}}
    tr = res["ctx"]["trace"]
    if tr is not None:
        line["device"].update(busy_s=tr["busy_s"], window_s=tr["wall_s"])
        line["breakdown"] = {"device_ops": tr["device_ops"],
                             "idle_gaps": tr["idle_gaps"]}
    line["checks"] = res["checks"]
    print(f"setup parts (s): {res['setup_parts']}", file=sys.stderr)
    for text in cell.limit_lines(res["checks"]):
        print(text, file=sys.stderr)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
