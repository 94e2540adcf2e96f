"""Host milliseconds a driven round of `Simulator._drive`'s draws (every
member's cohorts, realization, data indices and envelope padding): the
program's span fl.drive.draws over its counter fl.drive.rounds
(repro_torch.utils.spans, recorded while the profiler runs). A program
without the spans reads nothing."""


def read(ctx):
    try:
        from repro_torch.utils import spans
    except ImportError:
        return None
    snap = spans.snapshot()
    draws = snap["spans"].get("fl.drive.draws")
    rounds = snap["counters"].get("fl.drive.rounds")
    if draws is None or not rounds:
        return None
    return 1e3 * draws["s"] / rounds
