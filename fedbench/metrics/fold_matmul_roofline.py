"""The fold matmul's share of its roofline: the least time of the window's
useful products (harness/yardstick.py) over the device time of the
kernels named fold_ in the traced window."""


def read(ctx):
    tr = ctx["trace"]
    if not tr:
        return None
    fold = sum(s for k, s in tr["kernels"].items() if "fold_" in k)
    return 100.0 * ctx["least_s"] / fold if fold else None
