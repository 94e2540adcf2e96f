"""The asynchronous backend on the card, at `mnist_async` width
(compressed): one quantize launch per arrival event and the fold matmul
on every local step; the host's float32 schedule twin predicting every
pop the device makes; a mid-buffer checkpoint resuming bit for bit; and
no host synchronisation inside a chunk's event loop.

Imports no JAX, so it runs on a machine with the card and without the
reference's dependencies:

  PYTHONPATH=src python -m pytest tests/test_torch_async_cuda.py

Without a card the tests skip (the kernels have no CPU form; the CPU
parity of the async backend is held in tests/test_torch_async.py).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.federated import experiment
from repro_torch.federated.simulation import load_state, save_state
from repro_torch.kernels.fold_matmul import ops as fm_ops
from repro_torch.kernels.quantize import ops as q_ops
from repro_torch.utils.tree import leaves

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    # Decided at run time, never at import: every xdist worker must
    # collect the same tests.
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU form")
    return torch.device("cuda")


def _sim():
    spec = experiment.get("mnist_async")
    return spec.replace(fed=dataclasses.replace(
        spec.fed, compress_updates=True)).build()


def _same_bits(a, b):
    return all(torch.equal(x.contiguous().view(torch.int32),
                           y.contiguous().view(torch.int32))
               if x.dtype == torch.float32 else torch.equal(x, y)
               for x, y in zip(leaves(a), leaves(b)))


def test_one_quantize_launch_per_event(cuda_device):
    sim = _sim()
    q_ops.launches = fm_ops.launches = 0
    state, hist = sim.run_events(sim.init(), 11)
    assert q_ops.launches == state.event == 11
    assert fm_ops.launches > 0
    assert all(np.isfinite(r.train_loss) for r in hist)


def test_twin_predicts_every_pop_on_the_card(cuda_device, monkeypatch):
    """Every chunk's device pops equal the twin's (the simulator raises
    otherwise); a planted wrong prediction is caught."""
    sim = _sim()
    checked = []
    records = sim._async_records

    def spy(ys, evs, n_ev, r0, bits_acc):
        checked.append((list(ys["client"][:n_ev].astype(int)),
                        [e.client for e in evs]))
        return records(ys, evs, n_ev, r0, bits_acc)

    monkeypatch.setattr(sim, "_async_records", spy)
    state, res = sim.run(sim.init(), max_rounds=6, eval_every=2)
    assert len(checked) == 3 and all(a == b for a, b in checked)
    times = [r.sim_time for r in res.history]
    assert times == sorted(times)

    def planted(ys, evs, n_ev, r0, bits_acc):
        evs = [dataclasses.replace(evs[0], client=(evs[0].client + 1) % 10)
               ] + list(evs[1:])
        return records(ys, evs, n_ev, r0, bits_acc)

    monkeypatch.setattr(sim, "_async_records", planted)
    with pytest.raises(RuntimeError, match="twin diverged"):
        sim.run(state, max_rounds=1)


def test_mid_buffer_checkpoint_bits(cuda_device, tmp_path):
    sim = _sim()
    whole, res = sim.run(sim.init(), max_rounds=4)
    part, hist = sim.run_events(sim.init(), 7)
    path = str(tmp_path / "ck.pkl")
    save_state(path, part)
    part, rest = sim.run(load_state(path, like=sim.init()),
                         max_rounds=4 - len(hist))
    assert _same_bits((sim.params(whole), whole.async_c),
                      (sim.params(part), part.async_c))
    assert [(r.sim_time, r.train_loss, r.uplink_bits) for r in res.history] \
        == [(r.sim_time, r.train_loss, r.uplink_bits)
            for r in hist + rest.history]


def test_no_host_sync_inside_a_chunk(cuda_device):
    """One chunk's event loop under set_sync_debug_mode('error'): the
    inputs are uploaded before it and the outputs fetched after it."""
    sim = _sim()
    sim.run_events(sim.init(), 1)  # builds and loads the kernels
    state, mat, gen, twin, _ = sim._async_begin(sim.init())
    xs, _, n = sim._async_chunk_inputs(mat[0], twin, mat[1], stop_events=9)
    inputs = {"t_svc": torch.from_numpy(xs["t_svc"]).cuda(),
              "drop_next": torch.from_numpy(xs["drop_next"]).cuda(),
              "idx": torch.from_numpy(xs["idx"]).long().cuda()}
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = sim._chunk_fn(state.params_C, state.opt_C, gen, state.async_c,
                            sim._sizes, sim._data_dev, inputs)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert out[3]["client"].shape == (n,)
