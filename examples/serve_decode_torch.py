"""Serving on the PyTorch/CUDA port: batched prefill + token-by-token
decode against KV/SSM caches, across architecture families. The twin of
examples/serve_decode.py (same archs at their smoke configs, same
prints).

  PYTHONPATH=src python examples/serve_decode_torch.py               # card
  PYTHONPATH=src python examples/serve_decode_torch.py --device cpu
"""
import argparse
import sys

sys.path.insert(0, __file__.rsplit("/", 2)[0] + "/src")

from repro_torch.launch import serve  # noqa: E402

ARCHS = ["qwen2-0.5b", "falcon-mamba-7b", "zamba2-2.7b"]


def main(device: str = "cuda"):
    out = {}
    for arch in ARCHS:
        print(f"=== {arch} ===")
        out[arch] = serve.main(["--arch", arch, "--smoke", "--batch", "2",
                                "--prompt-len", "32", "--gen", "8",
                                "--device", device])
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    main(ap.parse_args().device)
