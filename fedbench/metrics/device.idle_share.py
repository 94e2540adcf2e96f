"""The share of the traced window in which no operation ran on the card."""


def read(ctx):
    tr = ctx["trace"]
    if not tr:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["wall_s"])
