#!/usr/bin/env python3
"""Time variants of the CUDA fold matmul kernel against the shipped one.

  python3 scripts/fold_variants.py [--cases NAME,NAME,...]

Needs an NVIDIA card and nvcc, as chip_smoke.py does. Each variant is the
shipped source (src/repro_torch/kernels/fold_matmul/csrc/fold_matmul.cu)
with textual changes, built into a git-ignored build/variants/ directory.
Every kernel is timed at chip_smoke.FOLD_CASES (by default those that
take the tiles or panel route) on the route the shipped wrapper picks, in
turns: shipped, each variant, shipped again (chip_smoke.time_ms, the
median of 5 runs of 5 launches after 2).

Variants:
  no_copy   no stage is copied after the ring's first STAGES - 1;
  no_math   no k of a stage is computed (copies and barriers only);
  bk16      128x64 with stages of 16 k, 4 of them;
  s16x128   16x64 as 16 x 128 tiles (256 threads);
  owners_only  a block of only the threads that own outputs (1x8: 8, 32x8:
            64, not 128, copy its stages);
  no_avec   1x8 reads its one row of A a k at a time, not 4;
  copy32    blocks of at least 32 threads, not 128 (the 1x8 slab's extra
            lanes copy, the 32x8 slab has no copy-only warps).
The first two compute wrong numbers on purpose: they only show which part
of the work bounds the kernel's time. The others give the shipped bits
(the contract holds for any tile).
"""
import argparse
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (puts this checkout's src/ on the path)

VARIANTS = {
    "no_copy": [("    if (t + STAGES - 1 < n_stages) load_stage(t + STAGES - 1);",
                 "")],
    "no_math": [("for (int k16 = 0; k16 < kn; k16 += kKStep)",
                 "for (int k16 = 0; k16 < 0 * kn; k16 += kKStep)")],
    # Other instance shapes, under the same ids (so the same routes):
    "bk16": [("X(0, 128, 64, 8, 4, 32, 3)", "X(0, 128, 64, 8, 4, 16, 4)")],
    "s16x128": [("X(1, 16, 64, 2, 4, 32, 4)", "X(1, 16, 128, 2, 4, 32, 4)")],
    # The small slabs' own choices, undone:
    "owners_only": [("kThreads = kOwners < 128 ? 128 : kOwners;",
                     "kThreads = kOwners;")],
    "no_avec": [("if constexpr (BM == 1) {", "if constexpr (BM == -1) {")],
    "copy32": [("kThreads = kOwners < 128 ? 128 : kOwners;",
                "kThreads = kOwners < 32 ? 32 : kOwners;")],
}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--cases", default="",
                        help="comma-separated FOLD_CASES names")
    args = parser.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("fold_variants: needs an NVIDIA card", file=sys.stderr)
        return 1
    from repro_torch.kernels import build
    from repro_torch.kernels.fold_matmul import ops
    card = chip_smoke.card_line()
    shipped = ops.SOURCE
    text = shipped.read_text()
    sources = {"shipped": shipped}
    for name, edits in VARIANTS.items():
        out = text
        for old, new in edits:
            if old not in out:
                raise SystemExit(f"variant {name}: {old!r} not in the source")
            out = out.replace(old, new)
        path = ROOT / "build" / "variants" / name / "csrc" / "fold_matmul.cu"
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(out)
        sources[name] = path
    with ThreadPoolExecutor(len(sources)) as ex:  # one nvcc a source
        list(ex.map(build.load, sources.values()))
    names = ([n for n in args.cases.split(",") if n] or [
        n for n, (batch, M, K, N, _) in chip_smoke.FOLD_CASES.items()
        if ops.route_for(batch, M, N, K) != "rows"])
    dev = torch.device("cuda")
    order = ["shipped", *VARIANTS, "shipped"]
    for case in names:
        batch, M, K, N, layout = chip_smoke.FOLD_CASES[case]
        a, b = chip_smoke.fold_inputs(case, dev)
        route = ops.route_for(batch, M, N, K)
        times = []
        for name in order:
            ops._kernel, ops.SOURCE = None, sources[name]
            times.append(chip_smoke.time_ms(lambda: ops.fold_matmul(a, b),
                                            warmup=2, calls=5, reps=5))
        print(f"[variants] {case} ({batch}, {M}, {K}) @ ({batch}, {K}, {N}) "
              f"{layout}, {route} ({ops.instance_for(route, batch, M, N)}) on "
              f"{card}: " + ", ".join(f"{n} {t:.4f} ms"
                                      for n, t in zip(order, times)),
              flush=True)
        del a, b
    ops._kernel, ops.SOURCE = None, shipped
    return 0


if __name__ == "__main__":
    sys.exit(main())
