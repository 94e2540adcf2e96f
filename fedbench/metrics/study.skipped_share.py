"""The share of a Study group's envelope sample-steps that its local steps
skip: 1 - computed / full, from the program's counters
fl.envelope.sample_steps (each computed step's live lanes times its rows,
summed) and fl.envelope.full_sample_steps (lanes x V_env x B_env a round)
(repro_torch.utils.spans, recorded while the profiler runs). A program
without the counters reads nothing."""


def read(ctx):
    try:
        from repro_torch.utils import spans
    except ImportError:
        return None
    counters = spans.snapshot()["counters"]
    done = counters.get("fl.envelope.sample_steps")
    full = counters.get("fl.envelope.full_sample_steps")
    if done is None or not full:
        return None
    return 100.0 * (1.0 - done / full)
