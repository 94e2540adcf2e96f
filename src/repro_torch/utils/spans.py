"""Named spans and counters of the port, recorded only while a
`torch.profiler` runs.

Outside a profiler every call here is one check of
`torch.autograd._profiler_enabled()` (~0.2 us) that returns at once: no
record_function, no clock read, no CUDA event, nothing stored. There is
no switch of its own: tracing is on while a profiler runs. Inside one:

- `span(name)`: a host range. It enters a profiler range named `name`,
  so the range lies on the profiler's timeline on the card's clock, and
  adds its perf_counter seconds and a count to the total of `name`. The
  range has the function scope of an aten op
  (`torch._C._profiler._RecordFunctionFast`), not the user scope of
  `torch.profiler.record_function`: the profiler mirrors a user-scope
  range onto the card's timeline as a GPU user annotation spanning every
  kernel launched inside it, which a trace reduction that sums the
  device's events counts as busy time a second time.
- `device_span(name, like)`: a pair of timing CUDA events on the current
  stream of `like`'s device around the work enqueued inside it (nothing for
  a tensor off CUDA). Its value is the stream's interval from the phase's
  first work to its last: its kernels and any wait for the host to launch
  them. Pairs under one name add up. They are resolved by `resolve()` at a
  point where the host already waits on the card, or by `snapshot()`:
  nothing here adds a synchronisation to the work it times.
- `count(name, n)`: adds n to a counter.

`snapshot()` gives the totals, `reset()` clears them. There is no exporter:
the profiler's `export_chrome_trace` shows the ranges, `snapshot()` the
totals.
"""
from __future__ import annotations

import time
from contextlib import nullcontext

import torch

_OFF = nullcontext()
_host: dict = {}      # name -> [count, seconds]
_device: dict = {}    # name -> [count, seconds]
_counters: dict = {}  # name -> total
_pending: list = []   # (name, start event, end event), not yet resolved


def _add(totals: dict, name: str, seconds: float) -> None:
    t = totals.setdefault(name, [0, 0.0])
    t[0] += 1
    t[1] += seconds


class _Span:
    __slots__ = ("name", "rf", "t0")

    def __init__(self, name: str):
        self.name = name
        self.rf = torch._C._profiler._RecordFunctionFast(name)

    def __enter__(self):
        self.rf.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self.t0
        self.rf.__exit__(*exc)
        _add(_host, self.name, dt)
        return False


class _DeviceSpan:
    __slots__ = ("name", "stream", "start")

    def __init__(self, name: str, device: torch.device):
        self.name = name
        self.stream = torch.cuda.current_stream(device)

    def __enter__(self):
        self.start = torch.cuda.Event(enable_timing=True)
        self.start.record(self.stream)
        return self

    def __exit__(self, *exc):
        end = torch.cuda.Event(enable_timing=True)
        end.record(self.stream)
        _pending.append((self.name, self.start, end))
        return False


def on() -> bool:
    """Whether a profiler runs, so that spans record."""
    return torch.autograd._profiler_enabled()


def span(name: str):
    """A host span named `name` (module docstring)."""
    if not torch.autograd._profiler_enabled():
        return _OFF
    return _Span(name)


def device_span(name: str, like: torch.Tensor):
    """A device span named `name` on the stream of `like`'s device (module
    docstring)."""
    if not torch.autograd._profiler_enabled() or not like.is_cuda:
        return _OFF
    return _DeviceSpan(name, like.device)


def count(name: str, n) -> None:
    """Adds n to the counter `name` while a profiler runs."""
    if torch.autograd._profiler_enabled():
        _counters[name] = _counters.get(name, 0) + n


def resolve() -> None:
    """The device spans' pending event pairs as seconds. Waits for each
    pair's end event: call it where the host already waits on the card."""
    for name, start, end in _pending:
        end.synchronize()
        _add(_device, name, start.elapsed_time(end) * 1e-3)
    _pending.clear()


def snapshot() -> dict:
    """{"spans": {name: {"n", "s"}}, "device": {name: {"n", "s"}},
    "counters": {name: value}}, the device spans resolved first."""
    resolve()
    return {"spans": {k: {"n": n, "s": s} for k, (n, s) in _host.items()},
            "device": {k: {"n": n, "s": s}
                       for k, (n, s) in _device.items()},
            "counters": dict(_counters)}


def reset() -> None:
    """Clears every total, counter and pending pair."""
    for d in (_host, _device, _counters):
        d.clear()
    _pending.clear()
