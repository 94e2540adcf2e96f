"""Declarative multi-arm studies: whole method comparisons as grouped
folded fleets.

Port of repro/federated/study.py. The paper's headline results are
*comparisons* — DEFL vs FedAvg vs Rand (Fig. 2), sweeps over epsilon, b
and theta (Fig. 1) — and each arm is one `ExperimentSpec`. A `Study` is
the frozen value form of the whole comparison:

    study = Study(
        arms=[("DEFL", defl_spec), ("FedAvg", fedavg_spec),
              ("Rand", rand_spec)],
        seeds=range(8), max_rounds=100, eval_every=1, target_acc=0.90)
    result = study.run()                 # on the CUDA card
    header, rows = result.table()
    json.dump(result.to_json(), f)

`run()` does not loop over arms. Arms are grouped by *shape signature*
(model, client count M, dataset, partition and population draw, the
PopulationSpec and its cohorts, scenario or trace, faults, lr,
compression):
everything the group's chunk
function or its shared inputs depend on EXCEPT the per-arm (b, V) plan.
Each group runs as ONE folded fleet over its (arm x seed) members, on
the simulator's one driver (`Simulator._drive`, as `run_fleet`):

  * the members are rows of the client axis (S*C rows, members major;
    C = K lanes for sampled arms, each member with its own cohorts);
    arms with mixed (b, V) plans share one chunk through the **(V, b)
    envelope**: every member's batch indices are zero-padded to the
    group's (V_env, B_env) = (max V, max b), and per-row masks make the
    padding inert (mesh_rounds.envelope_local_steps_fn: the members are
    stacked by V, largest first, so each local step runs only on the
    lanes still stepping, a prefix of the stack, at their largest b; a
    padded sample adds an exact 0 through cnn.cnn_loss_masked, the loss
    divides by the member's own b and V);
  * each member keeps its own simulator: its plan, data iterators,
    scenario stream, quantizer-noise generator, per-client compute times
    and update bits, so its Eq. 8 clock and uplink bits are its run
    alone's exactly; a compressed group quantizes all its members'
    clients in ONE kernel launch a round;
  * `target_acc` / `max_sim_time` stop members one by one: a stopped
    member leaves the stack (its envelope rows with it) and keeps its
    state, as in `run_fleet`;
  * eval at chunk boundaries is one `eval_batch_fn` call for the stacked
    members.

The reference promises each member bit identity with its run alone. The
port promises the member contract of `Study.run`'s docstring: records
exact, losses and params within run_fleet's bounds each round. On the
card, under the CNN's stacked gradient, a member's rounds are in fact its
run alone's bit for bit (cnn.cnn_value_and_grad).

An arm on backend='async' (the event queue) runs solo, seed by seed:
its event clock cannot share a chunk with round loops. Its aggregation
regime ('fedbuff/K=2/poly') fills the table's agg column.

`plans()` resolves each arm's analytic operating point (the DEFL plan
or the fixed-(b, V) Eq. 12/8 evaluation) without training.
"""
from __future__ import annotations

import dataclasses
import os
import pickle
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import defl
from repro_torch.federated.experiment import ExperimentSpec
from repro_torch.federated.simulation import (
    SimResult,
    SimState,
    Simulator,
    _atomic_pickle,
    _validate_run_args,
)
from repro_torch.sharding import collectives
from repro_torch.utils import spans
from repro_torch.utils.tree import leaves, tree_map

# The member contract a padded member's first round holds against its
# run alone (`Study.run`, `bit_check`): run_fleet's per-round bounds.
LOSS_RTOL = 1e-5
PARAM_ATOL = 5e-4


def _group_signature(spec: ExperimentSpec, fed) -> tuple:
    """Everything that shapes a group's chunk function or its shared
    inputs (model, data, partition and population draw, the PopulationSpec
    with its cohorts, client sharding, scenario or trace, the effective
    FaultModel, backend, lr, compression) EXCEPT the per-arm (b, V)
    plan, which the envelope absorbs, and the plan constants (epsilon,
    nu, c) that only exist to derive it. The guard and quorum are built
    into the group's chunk, and the fault inputs (deadlines, attempts)
    are per-arm host values that must agree across a group's members."""
    return (spec.model, spec.dataset, spec.n_train, spec.n_test, spec.alpha,
            spec.seed, spec.scenario, spec.trace, spec.effective_faults(),
            spec.heterogeneity, spec.compute, spec.wireless, spec.backend,
            spec.with_eval, spec.population, spec.shard_clients,
            fed.n_devices, fed.lr, fed.compress_updates)


@dataclass
class _Member:
    """One (arm x seed) row block of a group's folded fleet. `state`
    defaults to `sim.init(seed)`."""

    arm: int
    label: str
    sim: Simulator
    seed: int
    state: Optional[SimState] = None


def _member_env(sim: Simulator, V_env: int, B_env: int,
                forced: bool = False) -> dict:
    """The member's (V, b)-envelope masks (host numpy), repeated over its
    C client lanes when the group stacks them (one row a lane). Its steps
    compute its b rows, or B_env under a forced envelope (the bit_check
    probe: it must meet padded rows as wide as its group's)."""
    V, b = sim.fed.local_rounds, sim.fed.batch_size
    s_mask = np.zeros(B_env, np.float32)
    s_mask[:b] = 1.0
    return {"v_mask": np.arange(V_env) < V,
            "rows": np.int64(B_env if forced else b),
            "sample_mask": s_mask,
            "n_samples": np.float32(b), "v_count": np.float32(V)}


# The envelope's schedule (mesh_rounds.envelope_schedule) and its steps'
# row counts are host data; the masks the steps read go to the device.
_HOST_ENV = ("v_mask", "rows")


def _stack_order(members: List[_Member]) -> List[int]:
    """The group's stack order: its members by V, largest first (stable),
    so the lanes still stepping at each local step are a prefix of the
    stack."""
    return sorted(range(len(members)),
                  key=lambda i: -members[i].sim.fed.local_rounds)


def _run_group(members: List[_Member], max_rounds: int, eval_every: int,
               target_acc: Optional[float], max_sim_time: Optional[float],
               envelope: Optional[Tuple[int, int]] = None,
               ) -> List[Tuple[SimState, SimResult]]:
    """Run one shape group as a single folded fleet over its members, on
    the simulator's one driver (`Simulator._drive`) with each member's own
    simulator and the group's envelope. The members are stacked by V,
    largest first (`_stack_order`), and come back in the caller's order.
    `envelope` forces the (V_env, B_env) dims (the bit_check probe pads
    one member beyond its own shapes, and its steps then compute B_env
    rows); by default they are the group's maxima."""
    rep = members[0].sim
    with spans.span("fl.group.setup"):
        order = _stack_order(members)
        stack = [members[i] for i in order]
        if envelope is not None:
            V_env, B_env = envelope
        else:
            V_env = max(m.sim.fed.local_rounds for m in members)
            B_env = max(m.sim.fed.batch_size for m in members)
        C = rep._lanes_local  # this rank's lanes of each member when sharded
        envs = [_member_env(m.sim, V_env, B_env, envelope is not None)
                for m in stack]
        env = {k: np.repeat(np.stack([e[k] for e in envs]), C, axis=0)
               for k in envs[0]}
        env.update({k: torch.as_tensor(x, device=rep.device)
                    for k, x in env.items() if k not in _HOST_ENV})
        states = [m.state if m.state is not None else m.sim.init(m.seed)
                  for m in stack]
        evaluate = (rep._eval_members if rep.eval_batch_fn is not None
                    else None)
        chunk_fn = rep.build_chunk(envelope=True)
    out, histories = rep._drive(
        states, max_rounds, eval_every, target_acc, max_sim_time, evaluate,
        sims=[m.sim for m in stack], chunk_fn=chunk_fn, env=env)
    done = [None] * len(members)
    for i, m, st, h in zip(order, stack, out, histories):
        done[i] = (st, SimResult(history=h, params=m.sim.params(st),
                                 label=f"{m.label}[seed={m.seed}]",
                                 fed=m.sim.fed))
    return done


def _fmt(mean: float, std: float, nd: int, multi: bool) -> str:
    if not np.isfinite(mean):
        return ""
    if multi:
        return f"{mean:.{nd}f}+-{std:.{nd}f}"
    return str(round(mean, nd))


# -- study checkpointing ------------------------------------------------------
# One file per completed (arm, seed) member, written crash-safely
# (_atomic_pickle): a kill at any instant leaves only whole member files,
# and `Study.run(checkpoint_dir=..., resume=True)` loads them and runs the
# rest. Only the exact `arm{a:03d}_seed{s}.pkl` names are read, so a
# temp file a kill left behind is never opened. Tensors are stored on the
# CPU and loaded back onto the simulator's device.

_MEMBER_CKPT_VERSION = 1


def _member_ckpt_path(directory: str, arm: int, seed: int) -> str:
    return os.path.join(directory, f"arm{arm:03d}_seed{seed}.pkl")


def _to(tree, device):
    """Every tensor of `tree` as an own contiguous copy on `device`
    (never a view that would pickle its whole base)."""
    return tree_map(lambda x: x.detach().to(device).clone(
        memory_format=torch.contiguous_format), tree)


def _save_member(path: str, label: str, seed: int,
                 state: SimState, result: SimResult) -> None:
    cpu = torch.device("cpu")
    res = dataclasses.replace(result, params=_to(result.params, cpu))
    st = _state_to(state, cpu)
    payload = {"__repro_study_member__": _MEMBER_CKPT_VERSION,
               "label": label, "seed": int(seed), "state": st,
               "result": res}
    # A sharded study's ranks hold the same member: rank 0 writes it once.
    collectives.on_rank0(lambda: _atomic_pickle(path, payload))


def _load_member(path: str, label: str, seed: int, device,
                 ) -> Tuple[SimState, SimResult]:
    try:
        with open(path, "rb") as f:
            payload = pickle.load(f)
    except (pickle.UnpicklingError, EOFError, AttributeError) as e:
        raise ValueError(
            f"{path!r} is not a readable study checkpoint "
            f"(corrupt or truncated pickle): {e}") from e
    if not (isinstance(payload, dict)
            and "__repro_study_member__" in payload):
        raise ValueError(
            f"{path!r} does not hold a study member checkpoint")
    version = payload["__repro_study_member__"]
    if version != _MEMBER_CKPT_VERSION:
        raise ValueError(
            f"{path!r} holds member checkpoint schema v{version}, this "
            f"build reads v{_MEMBER_CKPT_VERSION}")
    if payload.get("label") != label or int(payload.get("seed", -1)) != seed:
        raise ValueError(
            f"checkpoint {path!r} holds arm {payload.get('label')!r} "
            f"seed {payload.get('seed')!r}, expected {label!r} seed {seed} "
            "— the study's arms/seeds changed since the checkpoint was "
            "written; point checkpoint_dir at a fresh directory")
    st, res = payload["state"], payload["result"]
    return (_state_to(st, device),
            dataclasses.replace(res, params=_to(res.params, device)))


def _state_to(state: SimState, device) -> SimState:
    """`state` with its tensors (an async state's event carry too) as own
    copies on `device`."""
    return dataclasses.replace(
        state, params_C=_to(state.params_C, device),
        opt_C=_to(state.opt_C, device),
        async_c=(None if state.async_c is None
                 else _to(state.async_c, device)))


@dataclass
class StudyResult:
    """Per-arm frame of a study run: histories, final states,
    time-to-accuracy, confidence bands, paper-style table + JSON emit."""

    labels: Tuple[str, ...]
    seeds: Tuple[int, ...]
    results: Dict[str, List[SimResult]]  # label -> per-seed SimResults
    states: Dict[str, List[SimState]]
    groups: Tuple[Tuple[str, ...], ...]  # grouping report (labels/group)
    target_acc: Optional[float] = None
    max_sim_time: Optional[float] = None
    # label -> cohort size K of sampled-participation arms (None for a
    # dense arm, whose K column stays blank).
    cohorts: Dict[str, Optional[int]] = dataclasses.field(
        default_factory=dict)
    # label -> "mode/K=buffer/staleness" for backend='async' arms (None =
    # synchronous): the aggregation regime column of table()/to_json().
    async_modes: Dict[str, Optional[str]] = dataclasses.field(
        default_factory=dict)

    def __getitem__(self, label: str) -> List[SimResult]:
        return self.results[label]

    def time_to_target(self, label: str) -> np.ndarray:
        """(S,) per-seed time to `target_acc`: NaN for a seed that never
        hit the target. With no target_acc every seed 'hits' at its total
        simulated time. `time_to_target_or_total` gives a finite number
        for every seed."""
        if not self.target_acc:
            return np.asarray([r.total_time for r in self.results[label]])
        return np.asarray([
            t if (t := r.time_to_accuracy(self.target_acc)) is not None
            else np.nan
            for r in self.results[label]], np.float64)

    def time_to_target_or_total(self, label: str) -> np.ndarray:
        """(S,) per-seed time to target, falling back to the member's
        total simulated time for seeds that missed (a missed seed costs
        its whole run)."""
        tta = self.time_to_target(label)
        totals = np.asarray([r.total_time for r in self.results[label]])
        return np.where(np.isfinite(tta), tta, totals)

    def target_hit_rate(self, label: str) -> float:
        """Fraction of seeds that reached `target_acc` (1.0 when no
        target was set: every run 'completes')."""
        return float(np.isfinite(self.time_to_target(label)).mean())

    def final_accs(self, label: str) -> np.ndarray:
        return np.asarray([
            next((h.test_acc for h in reversed(r.history)
                  if h.test_acc is not None), np.nan)
            for r in self.results[label]])

    def summary(self, label: str) -> Dict[str, float]:
        times = np.asarray([r.total_time for r in self.results[label]])
        accs = self.final_accs(label)
        have_acc = bool(np.isfinite(accs).any())
        tta = self.time_to_target(label)
        have_tta = bool(np.isfinite(tta).any())
        rounds = np.asarray([r.rounds for r in self.results[label]])
        parts = [h.n_participants for r in self.results[label]
                 for h in r.history if h.n_participants is not None]
        return {
            "total_time_mean": float(times.mean()),
            "total_time_std": float(times.std()),
            "final_acc_mean": (float(np.nanmean(accs)) if have_acc
                               else float("nan")),
            "final_acc_std": (float(np.nanstd(accs)) if have_acc
                              else float("nan")),
            # Means over the seeds that hit the target; the hit rate says
            # how many made it.
            "time_to_target_mean": (float(np.nanmean(tta)) if have_tta
                                    else float("nan")),
            "time_to_target_std": (float(np.nanstd(tta)) if have_tta
                                   else float("nan")),
            "target_hit_rate": self.target_hit_rate(label),
            "rounds_mean": float(rounds.mean()),
            "mean_participants": (float(np.mean(parts)) if parts
                                  else float("nan")),
            # Quorum-rejected rounds and recovery restarts summed over
            # seeds (0 for studies without those knobs).
            "rounds_rejected": int(sum(
                r.rounds_rejected for r in self.results[label])),
            "restarts": int(sum(
                len(r.restarts) for r in self.results[label])),
        }

    def reduction(self, label: str, baseline: str) -> float:
        """Paper-style '% overall-time reduction' of `label` vs `baseline`
        on mean time-to-target; missed seeds count their total run time
        (time_to_target_or_total)."""
        a = float(self.time_to_target_or_total(label).mean())
        b = float(self.time_to_target_or_total(baseline).mean())
        return 100.0 * (1.0 - a / b)

    def table(self) -> Tuple[str, List[tuple]]:
        """Paper-style per-arm rows:
        label,b,V,K,agg,rounds,mean_participants,overall_time_s,acc,
        time_to_target,rounds_rejected,restarts — K the sampled cohort size
        (blank for dense arms), agg the aggregation regime ('sync', or
        'mode/K=buffer/staleness' for backend='async' arms); time/acc as
        mean+-std
        bands when the study ran several seeds; rounds_rejected/restarts
        are seed totals."""
        multi = len(self.seeds) > 1
        rows = []
        for label in self.labels:
            s = self.summary(label)
            fed = self.results[label][0].fed
            K = self.cohorts.get(label)
            mode = self.async_modes.get(label)
            tta = self.time_to_target_or_total(label)
            hit = [r.time_to_accuracy(self.target_acc) is not None
                   for r in self.results[label]] if self.target_acc else []
            rows.append((
                label, fed.batch_size, fed.local_rounds,
                K if K is not None else "",
                mode if mode is not None else "sync",
                round(s["rounds_mean"], 1),
                (round(s["mean_participants"], 1)
                 if np.isfinite(s["mean_participants"]) else ""),
                _fmt(s["total_time_mean"], s["total_time_std"], 2, multi),
                _fmt(s["final_acc_mean"], s["final_acc_std"], 4, multi),
                (_fmt(float(tta.mean()), float(tta.std()), 2, multi)
                 if (not self.target_acc or any(hit)) else ""),
                s["rounds_rejected"],
                s["restarts"],
            ))
        return ("label,b,V,K,agg,rounds,mean_participants,overall_time_s,"
                "acc,time_to_target_s,rounds_rejected,restarts", rows)

    def to_json(self) -> dict:
        """Machine-readable emit: study config, grouping report, per-arm
        summaries and full per-seed histories."""
        arms = {}
        for label in self.labels:
            per_seed = []
            for seed, r in zip(self.seeds, self.results[label]):
                per_seed.append({
                    "seed": int(seed),
                    "rounds": r.rounds,
                    "total_time": r.total_time,
                    "time_to_target": (r.time_to_accuracy(self.target_acc)
                                       if self.target_acc else None),
                    "rounds_rejected": r.rounds_rejected,
                    "restarts": r.restarts,
                    "history": {
                        "round": [h.round for h in r.history],
                        "sim_time": [h.sim_time for h in r.history],
                        "train_loss": [float(h.train_loss)
                                       for h in r.history],
                        "test_acc": [h.test_acc for h in r.history],
                        "n_participants": [h.n_participants
                                           for h in r.history],
                        "uplink_bits": [h.uplink_bits for h in r.history],
                        "rejected": [h.rejected for h in r.history],
                    },
                })
            fed = self.results[label][0].fed
            arms[label] = {
                "b": fed.batch_size, "V": fed.local_rounds, "lr": fed.lr,
                "K": self.cohorts.get(label),
                "async": self.async_modes.get(label),
                "compress_updates": fed.compress_updates,
                "summary": self.summary(label),
                "per_seed": per_seed,
            }
        return {"seeds": [int(s) for s in self.seeds],
                "target_acc": self.target_acc,
                "max_sim_time": self.max_sim_time,
                "groups": [list(g) for g in self.groups],
                "arms": arms}


@dataclass(frozen=True)
class Study:
    """A frozen multi-arm comparison: `(label, ExperimentSpec)` arms, run
    seeds, and the shared run/stop policy. `run()` executes the whole
    study as grouped folded fleets (see the module docstring); `plans()`
    resolves the arms' analytic operating points without training.

    grouping='envelope' (default) fuses same-signature arms across their
    (b, V) plans; 'exact' also splits on (b, V): no padding, one device
    call a chunk for each distinct shape. bit_check=True probes round 1
    of every padded arm (padded in its group's envelope against its run
    alone) before the study spends its budget, and raises ValueError when
    the probe breaks the member contract (`run`'s docstring)."""

    arms: Tuple[Tuple[str, ExperimentSpec], ...]
    seeds: Tuple[int, ...] = (0,)
    max_rounds: int = 200
    eval_every: int = 1
    target_acc: Optional[float] = None
    max_sim_time: Optional[float] = None
    grouping: str = "envelope"
    bit_check: bool = False

    def __post_init__(self):
        object.__setattr__(self, "arms",
                           tuple((str(k), v) for k, v in self.arms))
        object.__setattr__(self, "seeds",
                           tuple(int(s) for s in self.seeds))
        labels = [k for k, _ in self.arms]
        if not labels:
            raise ValueError("Study needs at least one arm")
        if len(set(labels)) != len(labels):
            raise ValueError(f"duplicate arm labels: {labels}")
        if not self.seeds:
            raise ValueError("Study needs at least one seed")
        if self.grouping not in ("envelope", "exact"):
            raise ValueError(f"unknown grouping {self.grouping!r}")
        for label, spec in self.arms:
            if not isinstance(spec, ExperimentSpec):
                raise TypeError(f"arm {label!r}: expected ExperimentSpec, "
                                f"got {type(spec).__name__}")
            if spec.backend not in ("scan", "async"):
                raise ValueError(
                    f"arm {label!r}: studies run on backend='scan' or "
                    f"'async' (got {spec.backend!r})")

    def replace(self, **kw) -> "Study":
        return dataclasses.replace(self, **kw)

    # -- analytic ------------------------------------------------------------
    def plans(self) -> Dict[str, defl.DEFLPlan]:
        """Per-arm analytic operating points (no training): the DEFL plan
        for plan=True arms, the fixed-(b, V) Eq. 12/8 evaluation
        otherwise. Arms whose solve is a plain Alg. 1 problem
        (spec.plan_request() is not None) are solved together in ONE
        `defl.make_plan_batch` call, bit-identical to per-arm
        analytic_plan(); fixed-(b, V) baselines and deadline-fault arms
        keep their scalar paths."""
        reqs = [(label, spec.plan_request()) for label, spec in self.arms]
        batch = [(label, r) for label, r in reqs if r is not None]
        out: Dict[str, defl.DEFLPlan] = {}
        if batch:
            for (label, _), plan in zip(
                    batch, defl.make_plan_batch([r for _, r in batch])):
                out[label] = plan
        for label, spec in self.arms:
            if label not in out:
                out[label] = spec.analytic_plan()
        return out

    # -- execution -----------------------------------------------------------
    def build_sims(self, device=None) -> Dict[str, Simulator]:
        """Every arm's Simulator, built once on `device` ("cuda" unless
        "cpu" is asked for). `run()` builds its own when not given these;
        pass them in to reuse the builds (data, partition, population,
        plan) across runs of one study. Reuse is safe: simulators are
        state-in/state-out."""
        return {label: spec.build(device=device)
                for label, spec in self.arms}

    def run(self, sims: Optional[Dict[str, Simulator]] = None,
            checkpoint_dir: Optional[str] = None,
            resume: bool = True, device=None) -> StudyResult:
        """Execute the study on `device` ("cuda" unless "cpu" is asked
        for; ignored when `sims` are given, which carry their own).

        The member contract, on one device, of a study member against
        `Simulator.run` of its own simulator from the same state:
          * exact: the plan, round numbers, sim_time, T_cm, T_cp,
            uplink_bits, n_participants and rejected flags, over any
            number of rounds, and the round on which a max_sim_time stop
            falls (a target_acc stop follows test_acc, which follows the
            params);
          * within run_fleet's bounds: each round from equal states
            gives a train loss within 1e-5 relative and params within
            5e-4 absolute, for every member and every round.
        The reference promises bit identity (its `_ps_matmul` and
        `_seq_mean` keep XLA's sums the same under padding). The port's
        simulators from ExperimentSpec.build give the same on the card:
        every product of the CNN's local steps, of FedAvg and of eval is a
        fold_matmul, one fma chain over k whatever the number of rows or
        the padding (cnn.cnn_value_and_grad), so a padded member repeats
        its round alone bit for bit (chip_smoke.py's Study phase prints
        it for every member-round). The contract stays the bounds: on the
        CPU the products are torch.matmul, whose sums follow the shapes,
        and a Simulator built with another value_and_grad (vmap of
        autograd through cuDNN, whose algorithms change with the shapes)
        repeats only to float32 rounding, which the local steps amplify.
        bit_check holds round 1 of each padded arm to the bounds.

        With `checkpoint_dir` set, every completed (arm, seed) member is
        saved to `{checkpoint_dir}/arm{a:03d}_seed{s}.pkl` (temp file,
        fsync, rename), and with `resume=True` (the default) members whose
        file exists are loaded instead of run again: a killed study picks
        up where it left off. A checkpoint whose stored (label, seed)
        disagrees with the study raises ValueError rather than mixing
        studies."""
        _validate_run_args(self.max_rounds, self.eval_every)
        built = sims if sims is not None else self.build_sims(device)
        sims = [(label, spec, built[label]) for label, spec in self.arms]
        arm_of = {label: a for a, (label, _) in enumerate(self.arms)}
        done: Dict[Tuple[str, int], Tuple[SimState, SimResult]] = {}
        if checkpoint_dir is not None:
            checkpoint_dir = str(checkpoint_dir)
            os.makedirs(checkpoint_dir, exist_ok=True)
            if resume:
                for label, _, sim in sims:
                    for seed in self.seeds:
                        path = _member_ckpt_path(
                            checkpoint_dir, arm_of[label], seed)
                        if os.path.exists(path):
                            done[(label, seed)] = _load_member(
                                path, label, seed, sim.device)

        def finish(label: str, seed: int, st, res) -> None:
            done[(label, seed)] = (st, res)
            if checkpoint_dir is not None:
                _save_member(
                    _member_ckpt_path(checkpoint_dir, arm_of[label], seed),
                    label, seed, st, res)

        if self.target_acc:
            missing = [label for label, _, sim in sims
                       if sim.eval_fn is None and sim.eval_batch_fn is None]
            if missing:
                raise ValueError(
                    f"target_acc needs with_eval=True on every arm; "
                    f"missing eval: {missing}")
        groups: Dict[Any, List[Tuple[str, ExperimentSpec, Simulator]]] = {}
        order: List[Any] = []
        for i, (label, spec, sim) in enumerate(sims):
            if sim.masked_loss_fn is None or sim.backend == "async":
                # No envelope form (a hand-built Simulator), or an async arm
                # (its event clock cannot share a chunk with round loops):
                # the arm runs alone, seed by seed.
                sig: Any = ("__solo__", i)
            else:
                sig = _group_signature(spec, sim.fed)
                if self.grouping == "exact":
                    sig = sig + (sim.fed.batch_size, sim.fed.local_rounds)
            if sig not in groups:
                groups[sig] = []
                order.append(sig)
            groups[sig].append((label, spec, sim))
        if self.bit_check:
            for sig in order:
                self._bit_probe(groups[sig])
        for sig in order:
            if len(sig) == 2 and sig[0] == "__solo__":
                (label, _, sim), = groups[sig]
                for seed in self.seeds:
                    if (label, seed) in done:
                        continue
                    st, res = sim.run(
                        sim.init(seed), max_rounds=self.max_rounds,
                        eval_every=self.eval_every,
                        target_acc=self.target_acc,
                        max_sim_time=self.max_sim_time)
                    finish(label, seed, st, res)
                continue
            members = [
                _Member(arm=a, label=label, sim=sim, seed=seed)
                for a, (label, spec, sim) in enumerate(groups[sig])
                for seed in self.seeds
                if (label, seed) not in done
            ]
            if not members:
                continue  # every member restored from checkpoint
            for m, (st, res) in zip(members, _run_group(
                    members, self.max_rounds, self.eval_every,
                    self.target_acc, self.max_sim_time)):
                finish(m.label, m.seed, st, res)
        results: Dict[str, List[SimResult]] = {
            label: [done[(label, seed)][1] for seed in self.seeds]
            for label, _ in self.arms}
        states: Dict[str, List[SimState]] = {
            label: [done[(label, seed)][0] for seed in self.seeds]
            for label, _ in self.arms}
        return StudyResult(
            labels=tuple(label for label, _ in self.arms), seeds=self.seeds,
            results=results, states=states,
            groups=tuple(tuple(label for label, _, _ in groups[sig])
                         for sig in order),
            target_acc=self.target_acc, max_sim_time=self.max_sim_time,
            cohorts={label: (c.K if (c := spec.cohort_spec()) is not None
                             else None) for label, spec in self.arms},
            async_modes={
                label: (f"{a.mode}/K={a.buffer_size}/{a.staleness}"
                        if (a := spec.async_spec) is not None else None)
                for label, spec in self.arms})

    def _bit_probe(self, group) -> None:
        """Round 1 of each padded arm of a group (its envelope pads it),
        as a one-member group in the group's envelope, against a round of
        it alone from the same state: raises ValueError when it breaks
        the member contract (`run`'s docstring) — before the study spends
        its round budget on a grouping that would not reproduce its arms'
        runs alone."""
        if len(group) < 2:
            return
        V_env = max(sim.fed.local_rounds for _, _, sim in group)
        B_env = max(sim.fed.batch_size for _, _, sim in group)
        seed = self.seeds[0]
        for label, _, sim in group:
            if (sim.fed.local_rounds, sim.fed.batch_size) == (V_env, B_env):
                continue
            state, native = sim.run_chunk(sim.init(seed), rounds=1)
            m = _Member(arm=0, label=label, sim=sim, seed=seed)
            (_, res), = _run_group([m], 1, 1, None, None,
                                   envelope=(V_env, B_env))
            a, b = native[0], res.history[0]
            clock_ok = ((a.round, a.sim_time, a.T_cm, a.T_cp, a.uplink_bits,
                         a.n_participants, a.rejected)
                        == (b.round, b.sim_time, b.T_cm, b.T_cp,
                            b.uplink_bits, b.n_participants, b.rejected))
            loss_ok = (a.train_loss == b.train_loss
                       or abs(a.train_loss - b.train_loss)
                       <= LOSS_RTOL * abs(a.train_loss))
            params_ok = all(
                bool((x - y).abs().max() <= PARAM_ATOL)
                for x, y in zip(leaves(sim.params(state)),
                                leaves(res.params)))
            if not (clock_ok and loss_ok and params_ok):
                what = ("clock, bits or participants" if not clock_ok
                        else "loss" if not loss_ok else "params")
                raise ValueError(
                    f"bit_check: arm {label!r} diverges under the "
                    f"(V={V_env}, b={B_env}) envelope (round-1 {what}; "
                    f"loss {a.train_loss!r} vs {b.train_loss!r}); use "
                    "grouping='exact' for this study or split the arm out")
