"""Device milliseconds a driven round of the local steps (every lane's V
steps: the CNN, the fold matmul, the optimizer): the program's device span
fl.round.local, the stream's interval from the phase's first work to its
last, over the counter fl.drive.rounds (repro_torch.utils.spans, recorded
while the profiler runs). A program without the spans reads nothing."""


def read(ctx):
    try:
        from repro_torch.utils import spans
    except ImportError:
        return None
    snap = spans.snapshot()
    local = snap["device"].get("fl.round.local")
    rounds = snap["counters"].get("fl.drive.rounds")
    if local is None or not rounds:
        return None
    return 1e3 * local["s"] / rounds
