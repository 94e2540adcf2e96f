"""The share of the traced window in which `Simulator._drive` ran host phases
with nothing queued on the card: the host seconds of the program's spans
fl.group.setup and fl.drive.{enter,draws,upload,records,exit}
(repro_torch.utils.spans, recorded while the profiler runs) over the
window's wall seconds. A program without the spans reads nothing."""

EXPOSED = ("fl.group.setup", "fl.drive.enter", "fl.drive.draws",
           "fl.drive.upload", "fl.drive.records", "fl.drive.exit")


def read(ctx):
    try:
        from repro_torch.utils import spans
    except ImportError:
        return None
    host = spans.snapshot()["spans"]
    if not host or not ctx.get("window_s"):
        return None
    return 100.0 * sum(host[k]["s"] for k in EXPOSED if k in host) \
        / ctx["window_s"]
