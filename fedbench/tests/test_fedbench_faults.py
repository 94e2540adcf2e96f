"""The harness's whole run, past its look for a card, on small cells on the
CPU: sound, `correct` is true; with the timed path broken underneath,
`correct` comes out false, once for each fault a cell of this benchmark
can have. (One chip a cell: no exchange between chips to leave out.)"""
import numpy as np
import pytest
import torch

from repro_torch.federated import mesh_rounds, simulation
from repro_torch.models import cnn
from fedbench.tests.small import run_small

CELLS = ["mnist_paper.study_fig2", "mnist_paper.fleet16_int8",
         "mnist_paper.sampled_k50"]


def _state_unchanged(monkeypatch):
    """Every round hands back the params and optimizer state it got."""
    real = mesh_rounds.build_fleet_chunk

    def build(*a, **kw):
        chunk = real(*a, **kw)

        def still(params, opt_state, *rest):
            _, _, ys = chunk(params, opt_state, *rest)
            return params, opt_state, ys
        return still
    monkeypatch.setattr(mesh_rounds, "build_fleet_chunk", build)


def _half_batch(monkeypatch):
    """Each local step averages the first half of its batch."""
    real = cnn.cnn_value_and_grad

    def half(cfg, params, batch, sample_mask=None, n=None):
        B = batch["y"].shape[1]
        keep = {k: v[:, :B // 2] for k, v in batch.items()}
        if sample_mask is not None:
            sample_mask = sample_mask[:, :B // 2]
            n = sample_mask.sum(dim=1)
        return real(cfg, params, keep, sample_mask, n)
    monkeypatch.setattr(cnn, "cnn_value_and_grad", half)


def _round0_indices(monkeypatch):
    """Every round of a chunk of several rounds trains on round 0's batch
    indices (or batches). (Round 0's cohort weights in every round would
    change no bit here: a sampled cell's clients all hold as many rows.)"""
    real = mesh_rounds.build_fleet_chunk

    def first(x):
        return x[:1].expand_as(x).contiguous()

    def build(*a, **kw):
        chunk = real(*a, **kw)

        def step(params, opt_state, gens, weights, data, idx, *rest):
            if idx is not None:
                assert idx.shape[0] > 1
                idx = first(idx)
            else:
                data = {k: first(v) for k, v in data.items()}
            return chunk(params, opt_state, gens, weights, data, idx, *rest)
        return step
    monkeypatch.setattr(mesh_rounds, "build_fleet_chunk", build)


def _mean_over_envelope(monkeypatch):
    """A padded member's step divides its batch loss by the envelope's
    B_env instead of by its own b."""
    real = cnn.cnn_value_and_grad

    def padded(cfg, params, batch, sample_mask=None, n=None):
        if sample_mask is not None:
            n = torch.full_like(n, sample_mask.shape[1])
        return real(cfg, params, batch, sample_mask, n)
    monkeypatch.setattr(cnn, "cnn_value_and_grad", padded)


def _clock_altered(monkeypatch):
    """Each round's simulated clock one float64 ulp off where it is made."""
    real = simulation.Simulator._chunk_records

    def records(self, *a, **kw):
        out = real(self, *a, **kw)
        for r in out:
            r.sim_time = float(np.nextafter(r.sim_time, np.inf))
        return out
    monkeypatch.setattr(simulation.Simulator, "_chunk_records", records)


@pytest.mark.parametrize("cell_name", CELLS)
def test_sound_run_is_correct(cell_name):
    res = run_small(cell_name)
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0


@pytest.mark.parametrize("fault", [_state_unchanged, _half_batch,
                                   _clock_altered])
@pytest.mark.parametrize("cell_name", CELLS)
def test_broken_path_is_not_correct(cell_name, fault, monkeypatch):
    fault(monkeypatch)
    res = run_small(cell_name)
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("cell_name,fault", [
    ("mnist_paper.fleet16_int8", _round0_indices),
    ("mnist_paper.sampled_k50", _round0_indices),
    ("mnist_paper.study_fig2", _mean_over_envelope),
])
def test_chunk_and_envelope_faults_are_not_correct(cell_name, fault,
                                                   monkeypatch):
    """The rounds after a chunk's first, and the batch mask of a padded
    member, are held too."""
    fault(monkeypatch)
    res = run_small(cell_name)
    assert not res["correct"], res["checks"]
