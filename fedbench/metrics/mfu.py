"""The whole window's share of the card's peak at the model's dtype: the
useful flops of the window's member-rounds, as the configuration's model
family counts them (fedbench/families/), over the window's wall seconds
at the family's peak (67 TFLOP/s for the float32 CNN), both in ctx."""


def read(ctx):
    if not ctx["flops"]:
        return None
    return 100.0 * ctx["flops"] / (ctx["window_s"] * ctx["peak_flops"])
