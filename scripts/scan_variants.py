#!/usr/bin/env python3
"""Time variants of the CUDA selective-scan kernel against the shipped one.

  python3 scripts/scan_variants.py

Needs an NVIDIA card and nvcc, as chip_smoke.py does. Each variant is the
shipped source (src/repro_torch/kernels/selective_scan/csrc/
selective_scan.cu) with one textual change, built into the kernel's
git-ignored build/ directory. Every kernel is timed at the falcon-mamba-7b
prefill shape (B=4, S=2048, D=8192, N=16) and for one prompt (B=1), in
turns: shipped, each variant, shipped again. Each line gives its largest
error against the plain version as a share of max(1, max |plain|).

Variants:
  expf           precise expf(dt * A) in place of ex2.approx(dt * A log2 e):
                 what the exp2 decision saves, and its error;
  unroll1/4      1 or 4 groups of 4 steps unrolled (the kernel unrolls 2);
  kt16           tiles of 16 steps (the kernel's are 32);
  no_bc_loads    B and C taken from registers, not shared memory;
  no_exp         an FFMA in place of each exp;
  no_memory      no global loads (zero-filled tiles) and no stores of y.
The last three compute wrong numbers on purpose: they only show which
part of the work bounds the kernel's time.
"""
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke  # noqa: E402

STORE = "if (active && k0 + sub < nt) yt"
VARIANTS = {
    "expf": [("] * kLog2e;", "];"), ("ex2(dtv * a2[j])", "expf(dtv * a2[j])")],
    "unroll1": [("#pragma unroll 2\n    for (int k0",
                 "#pragma unroll 1\n    for (int k0")],
    "unroll4": [("#pragma unroll 2\n    for (int k0",
                 "#pragma unroll 4\n    for (int k0")],
    "kt16": [("constexpr int kT = 32;", "constexpr int kT = 16;")],
    "no_bc_loads": [(
        "        load_states<kS>(bv, &st.bc[0][k][kS * sub]);\n"
        "        load_states<kS>(cv, &st.bc[1][k][kS * sub]);",
        "#pragma unroll\n"
        "        for (int j = 0; j < kS; ++j) bv[j] = xv + j, cv[j] = dtv - j;")],
    "no_exp": [("ex2(dtv * a2[j])", "fmaf(dtv, a2[j], 1.f)")],
    "no_memory": [('"r"(ok ? 16 : 0)', '"r"(0)'), ('"r"(ok ? 4 : 0)', '"r"(0)'),
                  (STORE, "if (sum == -1.2345e-30f) yt")],
}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("scan_variants: needs an NVIDIA card", file=sys.stderr)
        return 1
    from repro_torch.kernels import build
    from repro_torch.kernels.selective_scan import ops, ref

    shipped = ops.SOURCE
    text = shipped.read_text()
    sources = {"shipped": shipped}
    for name, edits in VARIANTS.items():
        src = text
        for old, new in edits:
            if old not in src:
                raise SystemExit(f"variant {name}: {old!r} not in the source")
            src = src.replace(old, new)
        path = shipped.parent.parent / "build" / "variants" / name / "csrc"
        path.mkdir(parents=True, exist_ok=True)
        (path / shipped.name).write_text(src)
        sources[name] = path / shipped.name
    with ThreadPoolExecutor(len(sources)) as ex:
        logs = dict(zip(sources, ex.map(lambda p: build.load(p)[1],
                                        sources.values())))
    for name, log in logs.items():
        regs = [line.split(":")[-1].strip()[:40] for line in log.splitlines()
                if "registers" in line]
        print(f"[variants] {name}: {regs}", flush=True)

    card = chip_smoke.card_line()
    dev = torch.device("cuda")
    big = chip_smoke.scan_inputs("falcon_prefill_n16", dev)[:-1]
    one = chip_smoke.scan_inputs("falcon_prompt_1x2048x8192_n16", dev)[:-1]
    y_r, h_r = ref.selective_scan_ref(*big)
    for name in ["shipped", *VARIANTS, "shipped"]:
        ops._kernel = None
        ops.SOURCE = sources[name]
        y, h = ops.selective_scan(*big)
        torch.cuda.synchronize()
        err = max(float((y - y_r).abs().max()) / max(1.0, float(
            y_r.abs().max())), float((h - h_r).abs().max()) / max(1.0, float(
                h_r.abs().max())))
        ms4 = chip_smoke.time_ms(lambda: ops.selective_scan(*big))
        ms1 = chip_smoke.time_ms(lambda: ops.selective_scan(*one))
        print(f"[variants] {name} on {card}: B=4 {ms4:.4f} ms, B=1 "
              f"{ms1:.4f} ms, error {err:.3g} of scale", flush=True)
    ops._kernel = None
    ops.SOURCE = shipped
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
