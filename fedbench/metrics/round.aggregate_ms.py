"""Device milliseconds a driven round of the aggregation (FedAvg, or the
int8 noise draw, quantize and mean): the program's device span
fl.round.aggregate, the stream's intervals from each part's first work to
its last, over the counter fl.drive.rounds (repro_torch.utils.spans,
recorded while the profiler runs). A program without the spans reads
nothing."""


def read(ctx):
    try:
        from repro_torch.utils import spans
    except ImportError:
        return None
    snap = spans.snapshot()
    agg = snap["device"].get("fl.round.aggregate")
    rounds = snap["counters"].get("fl.drive.rounds")
    if agg is None or not rounds:
        return None
    return 1e3 * agg["s"] / rounds
