"""Event-driven asynchronous FL: the policy spec, staleness weights, and
the host float32 schedule twin of the device's event queue.

Port of repro/federated/events.py. The async backend
(simulation.Simulator(backend="async")) replaces the synchronous round
barrier with an event queue: every client carries a finish time, the
server repeatedly takes the EARLIEST finisher (argmin over a (C,) float32
array on the device: a priority-queue pop), applies its update to a
staleness-weighted buffer, and re-dispatches the client from the current
global model. The Eq. 8 round clock becomes an event clock: server time
is the arrival time of the update that fills the buffer (FedBuff, arXiv
2106.06639), not the straggler max.

The event loop itself is mesh_rounds.build_async_chunk; this module holds
what the host needs:

  AsyncSpec        the aggregation policy (buffer size, staleness
                   weighting, fedbuff vs fedasync server update).
  staleness_weight the weight function, on numpy float32 host values and
                   on torch tensors alike.
  TwinState,       a numpy float32 replay of the device's scheduling ops
  twin_step        (argmin pop, finish-time writes, buffer counting).
                   torch.argmin and np.argmin both take the first
                   minimum, and IEEE float32 adds are deterministic, so
                   the twin predicts EXACTLY which client arrives at each
                   event and which events aggregate: the simulator uses it
                   to end chunks at aggregation boundaries and to stack
                   each event's batches for only the arriving client.
  reference_run    a slow, plain Python event loop over host functions,
                   the parity oracle of the chunk (tests/test_torch_async.py).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.utils.tree import tree_map

STALENESS_MODES = ("constant", "poly", "exp")
ASYNC_MODES = ("fedbuff", "fedasync")


@dataclasses.dataclass(frozen=True)
class AsyncSpec:
    """Buffered asynchronous aggregation policy.

    buffer_size   K — the server aggregates once K accepted updates sit in
                  the buffer. K = M with staleness='constant' on a uniform
                  scenario degenerates to synchronous FedAvg (the
                  sync-limit identity contract, EXPERIMENTS.md
                  §Asynchronous execution).
    staleness     per-update weight from the update's staleness s =
                  server_version_now - server_version_at_dispatch:
                    'constant' w(s) = 1
                    'poly'     w(s) = (1 + s)^(-a)
                    'exp'      w(s) = exp(-a s)
    staleness_a   the decay constant a above (ignored for 'constant').
    mode          'fedbuff': params += sum_i w_i sizes_i delta_i /
                  sum_i w_i sizes_i once the buffer fills (weighted mean
                  of deltas — reduces to FedAvg in the sync limit).
                  'fedasync': immediate mixing params = (1 - lr w) params
                  + lr w new_params per update (requires buffer_size=1).
    server_lr     fedasync mixing rate (alpha in arXiv 1903.03934).
    event_budget  the most arrival events a chunk runs (E). None -> the
                  simulator picks 8 * max(C, buffer_size). A chunk also
                  ends at an aggregation boundary; the port runs only a
                  chunk's events (the reference pads every chunk to E for
                  its one compiled trace), so E bounds a chunk's host
                  stack and never changes a result.
    """

    buffer_size: int = 1
    staleness: str = "constant"
    staleness_a: float = 0.5
    mode: str = "fedbuff"
    server_lr: float = 1.0
    event_budget: Optional[int] = None

    def __post_init__(self):
        if self.mode not in ASYNC_MODES:
            raise ValueError(
                f"AsyncSpec.mode must be one of {ASYNC_MODES}, "
                f"got {self.mode!r}")
        if self.staleness not in STALENESS_MODES:
            raise ValueError(
                f"AsyncSpec.staleness must be one of {STALENESS_MODES}, "
                f"got {self.staleness!r}")
        if self.buffer_size < 1:
            raise ValueError(
                f"AsyncSpec.buffer_size must be >= 1, got {self.buffer_size}")
        if self.mode == "fedasync" and self.buffer_size != 1:
            raise ValueError(
                "AsyncSpec(mode='fedasync') aggregates every update "
                f"immediately — buffer_size must be 1, got {self.buffer_size}")
        if self.server_lr <= 0:
            raise ValueError(
                f"AsyncSpec.server_lr must be > 0, got {self.server_lr}")
        if self.event_budget is not None and self.event_budget < 1:
            raise ValueError(
                f"AsyncSpec.event_budget must be >= 1, "
                f"got {self.event_budget}")

    def replace(self, **kw) -> "AsyncSpec":
        return dataclasses.replace(self, **kw)


def staleness_weight(spec: AsyncSpec, s):
    """w(s) for staleness s, in float32: a numpy value or array (the host
    twin's and reference_run's) gives numpy, a torch tensor (the device
    chunk's) gives a tensor on its device. The torch form makes no host
    synchronisation (the decay constant enters as a Python scalar, rounded
    to float32 as np.float32(a) is); it takes the power or the
    exponential of the float32 argument in float64 and rounds once to
    float32, which stays within one ulp of numpy's float32 functions
    (torch's own float32 exp sits up to 2 ulp from numpy's)."""
    if torch.is_tensor(s):
        s = s.to(torch.float32)
        if spec.staleness == "constant":
            return torch.ones_like(s)
        a = float(np.float32(spec.staleness_a))
        if spec.staleness == "poly":
            base = (1.0 + s).to(torch.float64)
            return (base ** -a).to(torch.float32)
        return torch.exp((-a * s).to(torch.float64)).to(torch.float32)
    s = np.asarray(s, np.float32)
    if spec.staleness == "constant":
        return np.ones_like(s)
    a = np.float32(spec.staleness_a)
    if spec.staleness == "poly":
        return (np.float32(1.0) + s) ** (-a)
    return np.exp(-a * s)


@dataclasses.dataclass
class TwinState:
    """Host mirror of the scheduling slice of the device carry — ONLY the
    f32/int fields that decide which client pops next and which events
    aggregate. No params. np.float32 throughout so every add matches the
    device's float32 op bit for bit."""

    t_finish: np.ndarray     # (C,) f32 absolute finish times (+inf = blocked)
    t_next: np.ndarray       # (C,) f32 next service time of blocked clients
    drop: np.ndarray         # (C,) f32 1.0 = this dispatch will be dropped
    version: int             # server aggregation count
    version_disp: np.ndarray  # (C,) int32 server version at dispatch
    cnt: int                 # updates in the buffer
    now: np.float32          # event clock (arrival time of last event)
    # f64 bookkeeping for records (NOT part of the f32 schedule):
    t_cm_disp: np.ndarray    # (C,) f64 uplink seconds at dispatch
    attempts_disp: np.ndarray  # (C,) f64 uplink attempt count at dispatch

    def copy(self) -> "TwinState":
        return TwinState(
            self.t_finish.copy(), self.t_next.copy(), self.drop.copy(),
            self.version, self.version_disp.copy(), self.cnt, self.now,
            self.t_cm_disp.copy(), self.attempts_disp.copy())


@dataclasses.dataclass(frozen=True)
class TwinEvent:
    """One arrival event as the twin predicts it."""

    client: int          # arriving client index (argmin pop)
    t_event: np.float32  # arrival time (f32 event clock)
    dropped: bool        # update lost (scenario mask / fault realization)
    aggregated: bool     # this arrival filled the buffer
    staleness: int       # version - version_disp[client] at arrival
    # service components of the dispatch that JUST COMPLETED (what the
    # arriving update actually paid — consumed for RoundRecord.T_cm):
    t_cm_done: float
    attempts_done: float
    # dispatch-time service components of the NEXT task handed to the
    # client (consumed by the simulator when building records):
    t_cm_next: float
    attempts_next: float


def twin_init(t_finish0: np.ndarray, drop0: np.ndarray,
              t_cm0: np.ndarray, attempts0: np.ndarray) -> TwinState:
    """Fresh twin from the initial dispatch realization (all clients
    handed version-0 work at t=0)."""
    C = t_finish0.shape[0]
    return TwinState(
        t_finish=np.asarray(t_finish0, np.float32).copy(),
        t_next=np.zeros(C, np.float32),
        drop=np.asarray(drop0, np.float32).copy(),
        version=0,
        version_disp=np.zeros(C, np.int32),
        cnt=0,
        now=np.float32(0.0),
        t_cm_disp=np.asarray(t_cm0, np.float64).copy(),
        attempts_disp=np.asarray(attempts0, np.float64).copy())


def twin_step(spec: AsyncSpec, tw: TwinState, t_svc: np.ndarray,
              drop_next: np.ndarray, t_cm_next: np.ndarray,
              attempts_next: np.ndarray) -> TwinEvent:
    """Advance the twin by ONE arrival event, mutating tw in place.

    t_svc (C,) f32 — the service time (V t_cp + t_cm) the arriving client
    would get for its NEXT dispatch; only t_svc[c] is consumed, but the
    realization is drawn M-wide per event (prefix-stable stream
    consumption, mirroring the sync chunk's per-round draws).
    drop_next (C,) f32 — 1.0 where the next dispatch's update will be
    dropped (participation mask / fault realization, resolved at
    dispatch time exactly like the in-graph xs row).

    The arithmetic here replays mesh_rounds.build_async_chunk's scheduling
    ops verbatim in np.float32: argmin (first minimum), now = t_finish[c],
    drop re-dispatch t_finish[c] = now + t_svc[c], and the
    ack-at-aggregation release np.where(isinf(t_finish), now + t_next,
    t_finish). Both sides are IEEE f32, so the replay is exact — checked
    per chunk against the chunk's outputs in the simulator.
    """
    c = int(np.argmin(tw.t_finish))
    now = tw.t_finish[c]
    dropped = bool(tw.drop[c] > 0)
    s = tw.version - int(tw.version_disp[c])
    t_cm_done = float(tw.t_cm_disp[c])
    attempts_done = float(tw.attempts_disp[c])
    aggregated = False
    if dropped:
        # Lost update: immediate re-dispatch from the current model.
        tw.t_finish[c] = np.float32(now) + np.float32(t_svc[c])
    else:
        # Accepted update: block until the consuming aggregation acks.
        tw.cnt += 1
        tw.t_next[c] = np.float32(t_svc[c])
        tw.t_finish[c] = np.float32(np.inf)
        if spec.buffer_size == 1 or tw.cnt >= spec.buffer_size:
            aggregated = True
            tw.version += 1
            tw.cnt = 0
    tw.now = np.float32(now)
    tw.version_disp[c] = tw.version
    if aggregated:
        # Release every blocked client (including c) from the fresh
        # aggregate at the fill instant.
        idle = np.isinf(tw.t_finish)
        tw.t_finish = np.where(
            idle, np.float32(now) + tw.t_next,
            tw.t_finish).astype(np.float32)
        tw.version_disp = np.where(
            idle, np.int32(tw.version),
            tw.version_disp).astype(np.int32)
    tw.drop[c] = np.float32(drop_next[c])
    tw.t_cm_disp[c] = float(t_cm_next[c])
    tw.attempts_disp[c] = float(attempts_next[c])
    return TwinEvent(client=c, t_event=np.float32(now), dropped=dropped,
                     aggregated=aggregated, staleness=s,
                     t_cm_done=t_cm_done, attempts_done=attempts_done,
                     t_cm_next=float(t_cm_next[c]),
                     attempts_next=float(attempts_next[c]))


def reference_run(
    spec: AsyncSpec,
    n_events: int,
    init_params,
    init_opt,
    local_update: Callable,
    next_batches: Callable,
    sizes: np.ndarray,
    draw_dispatch: Callable,
):
    """Slow, plain Python event-loop executor — the parity oracle of the
    device chunk (tests/test_torch_async.py).

    local_update(params, opt_state, batches) -> (params', opt_state',
    mean_loss) runs one client's V local steps (e.g. the port's
    mesh_rounds.local_steps_fn on a one-row stack, unstacked around it);
    params may be trees of numpy arrays or of torch tensors.
    next_batches(client) yields that client's next V-batch stack —
    clients' data iterators advance ONLY when that client is dispatched,
    in arrival order (matching the twin-ordered batches the simulator
    stacks). draw_dispatch() -> (t_svc (C,) f32, drop (C,) f32) draws one
    M-wide dispatch realization; called once for the initial dispatch and
    once per event, in that order (the simulator's stream consumption
    contract).

    Returns (params, events) where params is a tree of float32 numpy
    arrays and events a list of dicts with the per-event fields (client,
    t_event, dropped, aggregated, staleness, weight) — enough to check
    every queue invariant.
    """
    t_svc0, drop0 = draw_dispatch()
    C = t_svc0.shape[0]
    tw = twin_init(t_svc0, drop0, np.zeros(C), np.zeros(C))
    f32 = lambda x: _host_f32(x)  # noqa: E731
    params_g = tree_map(f32, init_params)
    client_params = [params_g] * C
    client_opt = [init_opt] * C
    client_batches = [next_batches(c) for c in range(C)]
    buf = None
    buf_w = np.float32(0.0)
    sizes = np.asarray(sizes, np.float32)
    pending: set = set()  # clients blocked awaiting the aggregation ack
    events = []
    for _ in range(n_events):
        t_svc, drop_next = draw_dispatch()
        c = int(np.argmin(tw.t_finish))
        s = tw.version - int(tw.version_disp[c])
        # Run the client's local work (it was dispatched earlier with the
        # params snapshot held in client_params[c]).
        new_p, _, _ = local_update(
            client_params[c], client_opt[c], client_batches[c])
        new_p = tree_map(f32, new_p)
        delta = tree_map(lambda n, p: n - p, new_p, client_params[c])
        ev = twin_step(spec, tw, t_svc, drop_next,
                       np.zeros(C), np.zeros(C))
        assert ev.client == c and ev.staleness == s
        w = np.float32(staleness_weight(spec, s)) * sizes[c]
        if not ev.dropped:
            if spec.mode == "fedasync":
                ws = np.float32(staleness_weight(spec, s))
                a = np.float32(spec.server_lr) * ws
                params_g = tree_map(
                    lambda g, n: (np.float32(1.0) - a) * g + a * n,
                    params_g, new_p)
            else:
                contrib = tree_map(lambda d: w * d, delta)
                buf = contrib if buf is None else tree_map(
                    lambda b, x: b + x, buf, contrib)
                buf_w = buf_w + w
                if ev.aggregated:
                    params_g = tree_map(lambda g, b: g + b / buf_w,
                                        params_g, buf)
                    buf, buf_w = None, np.float32(0.0)
        events.append({"client": c, "t_event": float(ev.t_event),
                       "dropped": ev.dropped, "aggregated": ev.aggregated,
                       "staleness": s, "weight": float(w)})
        # Ack-at-aggregation re-dispatch: a dropped client restarts from
        # the current model immediately; an accepted client blocks until
        # the aggregation that consumes its update rebinds it (and every
        # other blocked client) to the fresh aggregate.
        if ev.dropped:
            client_params[c] = params_g
        else:
            pending.add(c)
        if ev.aggregated:
            for i in pending:
                client_params[i] = params_g
            pending.clear()
        client_batches[c] = next_batches(c)
    return params_g, events


def _host_f32(x) -> np.ndarray:
    """A numpy or torch leaf as a float32 numpy array on the host."""
    if torch.is_tensor(x):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float32)
