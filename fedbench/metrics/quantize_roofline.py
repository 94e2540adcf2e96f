"""The quantize kernel's share of its roofline: the bytes of the window's
quantize calls at 3.35 TB/s over the device time of the kernels named
quantize_rows in the traced window."""
from fedbench.harness import yardstick


def read(ctx):
    tr = ctx["trace"]
    if not tr or not ctx["quantize_bytes"]:
        return None
    q = sum(s for k, s in tr["kernels"].items() if "quantize_rows" in k)
    if not q:
        return None
    return 100.0 * ctx["quantize_bytes"] / yardstick.HBM_BYTES_PER_S / q
