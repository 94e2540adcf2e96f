"""Multi-pod demo, the twin of examples/multipod_dryrun_demo.py: the dry
run of one architecture on the 2x16x16 (512-device) production mesh,
counted on fake tensors (no device is touched), and its memory and cost
figures on the H100's numbers.

  PYTHONPATH=src python examples/multipod_dryrun_demo_torch.py [arch] [shape]

The record goes to experiments/multipod_demo_torch/ in this checkout.
"""
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "src"))

OUT = os.path.join(REPO, "experiments", "multipod_demo_torch")


def main(argv=None) -> int:
    from repro_torch.launch import dryrun
    argv = sys.argv[1:] if argv is None else argv
    arch = argv[0] if len(argv) > 0 else "gemma-7b"
    shape = argv[1] if len(argv) > 1 else "train_4k"
    rc = dryrun.main(["--arch", arch, "--shape", shape, "--mesh", "multi",
                      "--out", OUT])
    if rc == 0:
        with open(os.path.join(OUT, f"{arch}--{shape}--multi.json")) as f:
            rec = json.load(f)
        print(json.dumps({k: rec[k] for k in (
            "mesh_shape", "memory", "flops_per_device", "bytes_per_device",
            "terms_seconds", "dominant", "model_flops",
            "useful_flops_ratio", "flops_vs_analytic",
            "flops_vs_analytic_as_run", "counted")}))
        print(json.dumps({"collectives": {
            k: rec["collectives"][k] for k in ("count", "total_bytes",
                                               "total_wire_bytes")}}))
    return rc


if __name__ == "__main__":
    sys.exit(main())
