"""Host milliseconds a round of a sampled chunk's draws (cohorts, the M-wide
realization and its uplink times, the index stack), timed after the window
at its end state (kinds/sampled.py host_draws)."""


def read(ctx):
    draw = ctx.get("host_draw_s")
    return None if draw is None else 1e3 * draw
