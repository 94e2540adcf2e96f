"""Checkpoint and resume of the port's simulator: the twin of the
reference's tests/test_checkpoint_resume.py.

A SimState saved mid-run (`save_state`), restored (`load_state`) into a
freshly built Simulator and resumed gives the rest of the history bit for
bit — losses, clocks, participation counts, uplink bits and final params
— on every backend, with and without a scenario, across ragged chunk
boundaries. The payload is validated on load (version, type, shape
signature, `like=`), and a state resumes only on the kind of device its
noise generator came from (the reference's `jax.device_get` round trip
becomes a CPU round trip and that check).
"""
import dataclasses
import os
import pickle

import numpy as np
import pytest
import torch

from repro_torch.configs.base import FedConfig
from repro_torch.federated import experiment
from repro_torch.federated.simulation import SimState, load_state, save_state
from repro_torch.utils.tree import leaves


@pytest.fixture(autouse=True)
def _one_thread():
    """Small models run fastest on one intra-op thread, and the test
    runner's workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _spec(backend, scenario):
    return experiment.get("mnist_smoke").replace(
        with_eval=False, backend=backend, scenario=scenario,
        fed=FedConfig(n_devices=3, batch_size=8, theta=0.62, lr=0.05,
                      compress_updates=True))


def _build(spec):
    return spec.build(device="cpu")


def _tail_matches(full_tail, resumed):
    assert len(full_tail) == len(resumed)
    for x, y in zip(full_tail, resumed):
        assert x.round == y.round
        assert x.train_loss == y.train_loss
        assert x.sim_time == y.sim_time
        assert x.T_cm == y.T_cm and x.T_cp == y.T_cp
        assert x.n_participants == y.n_participants
        assert x.uplink_bits == y.uplink_bits


@pytest.mark.parametrize("backend", ["loop", "batched", "scan"])
@pytest.mark.parametrize("scenario", [None, "hetero_storm"])
def test_resume_bit_identical(backend, scenario, tmp_path):
    """Interrupt at round 3 of 6 with eval_every=2 (so the scan backend
    crosses a ragged chunk boundary before and after the save), round-trip
    the state through disk, resume on a FRESH Simulator."""
    spec = _spec(backend, scenario)
    sim = _build(spec)
    _, full = sim.run(sim.init(7), max_rounds=6, eval_every=2)
    simA = _build(spec)
    mid, _ = simA.run(simA.init(7), max_rounds=3, eval_every=2)
    path = os.path.join(tmp_path, "state.pkl")
    save_state(path, mid)
    restored = load_state(path, like=simA.init())
    assert isinstance(restored, SimState)
    assert restored.round == 3 and restored.seed == 7
    simB = _build(spec)  # fresh: new iterators, new round functions
    end, resumed = simB.run(restored, max_rounds=3, eval_every=2)
    _tail_matches(full.history[3:], resumed.history)
    for a, b in zip(leaves(full.params), leaves(resumed.params)):
        assert torch.equal(a, b)
    assert end.round == 6


def test_saved_tensors_are_own_cpu_copies(tmp_path):
    """save_state stores contiguous CPU clones, never views: a scan
    state's params are views of one global model (replicate_clients),
    saved as C full rows."""
    spec = _spec("scan", None)
    sim = _build(spec)
    state = sim.init(0)
    assert state.params_C["conv1"]["w"].stride()[0] == 0  # a view
    path = os.path.join(tmp_path, "s.pkl")
    save_state(path, state)
    with open(path, "rb") as f:
        saved = pickle.load(f)["state"]
    for x, y in zip(leaves(saved.params_C), leaves(state.params_C)):
        assert x.is_contiguous() and x.device.type == "cpu"
        assert x.untyped_storage().nbytes() == x.numel() * x.element_size()
        assert torch.equal(x, y)


def test_state_cpu_roundtrip_and_generator_kind(tmp_path):
    """A CPU state saved and loaded resumes as the state itself does; a
    state whose noise generator is of the other kind (a CUDA generator's
    16-byte state here) is refused by run, run_round and load_state(like=)
    with a ValueError naming the generator, not set on the wrong kind."""
    spec = _spec("scan", "dropout")
    sim = _build(spec)
    state, _ = sim.run(sim.init(0), max_rounds=2, eval_every=2)
    path = os.path.join(tmp_path, "s.pkl")
    save_state(path, state)
    host = load_state(path, like=sim.init())
    assert (host.round, host.sim_time) == (state.round, state.sim_time)
    _, from_host = sim.run(host, max_rounds=2, eval_every=2)
    _, from_state = sim.run(state, max_rounds=2, eval_every=2)
    _tail_matches(from_state.history, from_host.history)
    card = dataclasses.replace(host, rng=torch.zeros(16, dtype=torch.uint8))
    for call in (lambda: sim.run(card, max_rounds=1),
                 lambda: sim.run_round(card)):
        with pytest.raises(ValueError, match="CUDA generator"):
            call()
    save_state(path, card)
    with pytest.raises(ValueError, match="CUDA generator"):
        load_state(path, like=sim.init())


def test_load_state_rejects_non_state(tmp_path):
    path = os.path.join(tmp_path, "junk.pkl")
    with open(path, "wb") as f:
        pickle.dump({"not": "a state"}, f)
    with pytest.raises(ValueError, match="SimState"):
        load_state(path)


def _saved_state(spec, tmp_path, seed=0, name="ckpt.pkl"):
    sim = _build(spec)
    state, _ = sim.run(sim.init(seed), max_rounds=2, eval_every=2)
    path = os.path.join(tmp_path, name)
    save_state(path, state)
    return path


def test_load_state_rejects_version_skew(tmp_path):
    path = _saved_state(_spec("scan", None), tmp_path)
    with open(path, "rb") as f:
        payload = pickle.load(f)
    payload["__repro_simstate__"] = 999
    with open(path, "wb") as f:
        pickle.dump(payload, f)
    with pytest.raises(ValueError, match="schema v999"):
        load_state(path)


def test_load_state_rejects_corrupt_signature(tmp_path):
    path = _saved_state(_spec("scan", None), tmp_path)
    with open(path, "rb") as f:
        payload = pickle.load(f)
    tree, shapes = payload["signature"]
    payload["signature"] = (tree, shapes[:-1])  # a truncated leaf list
    with open(path, "wb") as f:
        pickle.dump(payload, f)
    with pytest.raises(ValueError, match="corrupt"):
        load_state(path)


def test_load_state_rejects_wrong_spec_via_like(tmp_path):
    path = _saved_state(_spec("scan", None), tmp_path)
    other = _spec("scan", None).replace(
        fed=FedConfig(n_devices=4, batch_size=8, theta=0.62, lr=0.05,
                      compress_updates=True))
    with pytest.raises(ValueError, match="different spec"):
        load_state(path, like=_build(other).init(0))
    # a loop state's layout (unstacked params, M optimizer states) differs
    with pytest.raises(ValueError, match="different spec"):
        load_state(path, like=_build(_spec("loop", None)).init(0))
    state = load_state(path, like=_build(_spec("scan", None)).init(0))
    assert isinstance(state, SimState)


def test_load_state_rejects_truncated_pickle(tmp_path):
    path = _saved_state(_spec("scan", None), tmp_path)
    raw = open(path, "rb").read()
    with open(path, "wb") as f:
        f.write(raw[: len(raw) // 2])
    with pytest.raises(ValueError, match="not a readable checkpoint"):
        load_state(path)


def test_load_state_accepts_legacy_raw_pickle(tmp_path):
    """A bare pickled SimState (the reference's pre-envelope form) loads
    and resumes unchanged."""
    spec = _spec("scan", "dropout")
    sim = _build(spec)
    state, _ = sim.run(sim.init(0), max_rounds=2, eval_every=2)
    path = os.path.join(tmp_path, "legacy.pkl")
    with open(path, "wb") as f:
        pickle.dump(state, f)
    restored = load_state(path, like=_build(spec).init(0))
    assert isinstance(restored, SimState) and restored.round == 2
    _, resumed = _build(spec).run(restored, max_rounds=2, eval_every=2)
    _, ref = _build(spec).run(state, max_rounds=2, eval_every=2)
    _tail_matches(ref.history, resumed.history)


def test_max_sim_time_stop_leaves_resumable_state():
    """A max_sim_time stop inside a chunk leaves the state's host streams
    at the stopping round, not the chunk's end: the resumed run's
    stream-driven accounting continues where the uninterrupted run's
    does (the params stay end-of-chunk, the reference's documented
    deviation, so the losses may differ)."""
    spec = _spec("scan", "hetero_storm")
    simA = _build(spec)
    _, full = simA.run(simA.init(3), max_rounds=6, eval_every=4)
    budget = full.history[1].sim_time  # stops at round 2, mid 4-chunk
    simB = _build(spec)
    state, res = simB.run(simB.init(3), max_rounds=6, eval_every=4,
                          max_sim_time=budget)
    assert len(res.history) == 2 and state.round == 2
    assert state.sim_time == full.history[1].sim_time
    _, nxt = simB.run(state, max_rounds=1)
    rec, ref = nxt.history[0], full.history[2]
    assert rec.round == 3
    assert rec.n_participants == ref.n_participants
    assert rec.T_cm == ref.T_cm and rec.T_cp == ref.T_cp
    assert rec.sim_time == ref.sim_time


@pytest.mark.parametrize("backend", ["batched", "loop"])
def test_per_round_max_sim_time_stop_resumes_exactly(backend):
    """On the per-round backends a max_sim_time stop falls after the round
    that reaches it, with that round's state: resuming gives the
    uninterrupted run's remaining rounds bit for bit."""
    spec = _spec(backend, "hetero_storm")
    sim = _build(spec)
    _, full = sim.run(sim.init(3), max_rounds=4)
    state, res = sim.run(sim.init(3), max_rounds=4,
                         max_sim_time=full.history[1].sim_time)
    assert len(res.history) == 2 and state.round == 2
    _, rest = sim.run(state, max_rounds=2)
    _tail_matches(full.history[2:], rest.history)


def test_fleet_resumes_from_checkpoints(tmp_path):
    """Checkpointed states come back as a fleet: S saved mid-run states
    run_fleet in lockstep give each one's resumed run alone."""
    spec = _spec("scan", "dropout")
    sim = _build(spec)
    paths = []
    for s in (0, 1):
        mid, _ = sim.run(sim.init(s), max_rounds=2, eval_every=2)
        p = os.path.join(tmp_path, f"m{s}.pkl")
        save_state(p, mid)
        paths.append(p)
    fleet = sim.run_fleet(states=[load_state(p) for p in paths],
                          max_rounds=4, eval_every=2)
    for i, p in enumerate(paths):
        _, ref = sim.run(load_state(p), max_rounds=4, eval_every=2)
        assert [(r.round, r.sim_time, r.T_cm, r.T_cp, r.n_participants,
                 r.uplink_bits) for r in ref.history] == [
            (r.round, r.sim_time, r.T_cm, r.T_cp, r.n_participants,
             r.uplink_bits) for r in fleet.results[i].history]
        np.testing.assert_allclose(
            [r.train_loss for r in fleet.results[i].history],
            [r.train_loss for r in ref.history], rtol=1e-5)
