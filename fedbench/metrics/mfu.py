"""The whole window's share of the card's float32 peak: the useful flops of
the window's member-rounds, counted from the CNN's shapes
(harness/yardstick.py), over the window's wall seconds at 67 TFLOP/s."""
from fedbench.harness import yardstick


def read(ctx):
    if not ctx["flops"]:
        return None
    return 100.0 * ctx["flops"] / (ctx["window_s"] * yardstick.PEAK_FP32_FLOPS)
