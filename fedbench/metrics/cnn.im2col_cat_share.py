"""The share of the traced window's device time in the im2col copies of
models/cnn.py _patches: kernels named CatArrayBatchedCopy."""


def read(ctx):
    tr = ctx["trace"]
    if not tr or not tr["busy_s"]:
        return None
    cat = sum(s for k, s in tr["kernels"].items() if "CatArrayBatchedCopy" in k)
    return 100.0 * cat / tr["busy_s"] if cat else None
