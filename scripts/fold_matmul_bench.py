#!/usr/bin/env python3
"""Time a source tree's fold matmul kernel at chip_smoke.py's FOLD_CASES.

  python3 scripts/fold_matmul_bench.py [--src DIR] [--tag NAME]
                                       [--cases NAME,...] [--route ROUTE]

DIR is the `src/` of a checkout (default: this one's), for example a
parent commit unpacked with `git archive` into a git-ignored directory, so
that two versions are timed in turns within one run on one card (parent,
change, change, parent). For each case the script prints the route the
tree's wrapper takes, the kernel's time per launch and torch.bmm's (CUDA
events: chip_smoke.time_ms, the median of 5 runs of 5 launches after 2),
and the kernel's time on the device alone (chip_smoke.device_ms:
torch.profiler over 10 launches), beside the card's name and power limit.
The kernel is built with nvcc at its first launch, into the tree's
git-ignored build/ directory. Needs an NVIDIA card. --route forces one
of this tree's routes or instances (ops.INSTANCES) on every case, to time
the choices route_for and instance_for did not make.
"""
import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (puts this checkout's src/ on the path)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--src", default=str(ROOT / "src"),
                        help="the src/ directory whose kernel is timed")
    parser.add_argument("--tag", default="this tree",
                        help="the name printed on every line")
    parser.add_argument("--cases", default="",
                        help="comma-separated FOLD_CASES names (default all)")
    parser.add_argument("--route", default=None,
                        help="a route or instance forced on every case")
    args = parser.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("fold_matmul_bench: needs an NVIDIA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(args.src).resolve()))
    from repro_torch.kernels.fold_matmul import ops
    if not Path(ops.__file__).resolve().is_relative_to(
            Path(args.src).resolve()):
        raise SystemExit(f"imported {ops.__file__}, not from {args.src}")
    card = chip_smoke.card_line()
    dev = torch.device("cuda")
    ops.load_kernel()
    names = [n for n in args.cases.split(",") if n] or chip_smoke.FOLD_CASES
    for name in names:
        batch, M, K, N, layout = chip_smoke.FOLD_CASES[name]
        a, b = chip_smoke.fold_inputs(name, dev)
        if args.route is not None:
            route = args.route
        else:
            try:
                route = ops.route_for(batch, M, N, K)
            except TypeError:  # a tree whose route_for takes no K
                route = ops.route_for(batch, M, N)

        def call():
            return ops.fold_matmul(a, b, route=args.route)

        ms = chip_smoke.time_ms(call, warmup=2, calls=5, reps=5)
        bmm_ms = chip_smoke.time_ms(lambda: torch.bmm(a, b), warmup=2,
                                    calls=5, reps=5)
        dev_ms = chip_smoke.device_ms(call)
        print(f"[bench] {args.tag} fold_matmul {name} ({batch}, {M}, {K}) @ "
              f"({batch}, {K}, {N}) {layout} on {card}: {route} route, "
              f"kernel {ms!r} ms ({dev_ms!r} on the device), torch.bmm "
              f"{bmm_ms!r} ms", flush=True)
        del a, b
    return 0


if __name__ == "__main__":
    sys.exit(main())
