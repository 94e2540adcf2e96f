"""The port's training path against the JAX reference: `loss_fn` and its
gradients, the flash kernel's autograd Function, the token data, `adamw`,
and `launch/train.py` end to end.

The same numpy inputs (or the reference's init_params, carried over by
convert.to_torch) go to both packages. Tolerances, set from float32:

- `loss_fn` in a float32 variant of each smoke config: the loss within
  1e-5 relative, each gradient leaf within 1e-5 of that leaf's largest
  |gradient| (the GEMMs sum in another order: XLA's Eigen against
  oneDNN, a few ulps of the largest terms);
- the flash Function's gradients on the CPU (the kernel's forward stood
  in by the plain version) against autograd through the plain version:
  exact, as both are the same VJP;
- the token stream and windows: exact (the same numpy RNG calls);
- `adamw`: 1e-6 absolute over 20 steps on O(1) parameters;
- train.py in float32 (the reference's get_config patched to the float32
  variant, the port given it as `cfg`): the DEFL plan line and every `sim_time` exact; every client's
  V step losses within 1e-5 relative and the final params within 1e-5 of
  each leaf's largest |value| (2 rounds of 2 clients x 2 steps).
"""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as j_registry
from repro.data import pipeline as j_pipeline
from repro.data import synthetic as j_synthetic
from repro.launch import train as j_train
from repro.models import transformer as j_tfm
from repro.optim import adamw as j_adamw
from repro.optim import apply_updates as j_apply
from repro_torch.configs import registry
from repro_torch.convert import to_numpy, to_torch
from repro_torch.data import make_token_stream, token_batches
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.launch import train
from repro_torch.models import transformer as tfm
from repro_torch.optim import AdamState, adamw, apply_updates, sgd
from repro_torch.utils.tree import leaves, tree_map

LOSS_RTOL = 1e-5
GRAD_TOL = 1e-5  # of each leaf's largest |gradient|
ADAM_ATOL = 1e-6
PARAM_TOL = 1e-5  # of each leaf's largest |value|


def _leaf_close(got, want, tol):
    """Each leaf within tol * max(|want_leaf|) (or tol where it is 0)."""
    for a, b in zip(leaves(to_numpy(got)), jax.tree.leaves(want)):
        b = np.asarray(b, np.float32)
        scale = float(np.max(np.abs(b))) or 1.0
        np.testing.assert_allclose(a, b, rtol=0, atol=tol * scale)


def _batch(cfg, rng, B=2, S=12, prefix=False):
    m = cfg.modality
    shape = (B, S, m.n_codebooks) if m and m.kind == "audio" else (B, S)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, shape).astype(np.int32)}
    if prefix:
        batch["prefix_embeds"] = rng.normal(
            0, 1, (B, m.prefix_len, m.embed_dim)).astype(np.float32)
    return batch


# ---------------------------------------------------------------------------
# loss_fn and its gradients
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch,prefix", [("qwen2-0.5b", False),
                                         ("musicgen-large", True),
                                         ("musicgen-large", False)])
def test_loss_fn_value_and_grads_match_reference(arch, prefix):
    j_cfg = j_registry.get_config(arch, smoke=True).replace(dtype="float32")
    t_cfg = registry.get_config(arch, smoke=True).replace(dtype="float32")
    j_params = j_tfm.init_params(j_cfg, jax.random.PRNGKey(1))
    t_params = to_torch(jax.tree.map(np.asarray, j_params), device="cpu")
    batch = _batch(t_cfg, np.random.default_rng(2), prefix=prefix)

    (j_loss, j_aux), j_grads = jax.jit(jax.value_and_grad(
        lambda p: j_tfm.loss_fn(j_cfg, p, jax.tree.map(jnp.asarray, batch)),
        has_aux=True))(j_params)
    p = tree_map(lambda t: t.requires_grad_(True), t_params)
    t_batch = {k: torch.tensor(v) for k, v in batch.items()}
    for impl in ("plain", "kernel"):
        loss, aux = tfm.loss_fn(t_cfg, p, t_batch, impl)
        grads = train.grads_of(loss, leaves(p))
        np.testing.assert_allclose(float(loss.detach()), float(j_loss),
                                   rtol=LOSS_RTOL)
        np.testing.assert_allclose(float(aux["ce_loss"].detach()),
                                   float(j_aux["ce_loss"]), rtol=LOSS_RTOL)
        assert float(aux["aux_loss"]) == float(j_aux["aux_loss"]) == 0.0
        assert len(grads) == len(jax.tree.leaves(j_grads))
        _leaf_close(list(grads), j_grads, GRAD_TOL)
    if cfg_has_projector := "projector" in p:
        # Through the text positions only when the prefix is there; unused
        # (zeros, as JAX gives) without it.
        j = [i for i, t in enumerate(leaves(p)) if t is p["projector"]["w"]]
        assert bool(grads[j[0]].abs().max() > 0) == prefix
    assert cfg_has_projector == (arch == "musicgen-large")


def test_loss_fn_scores_text_positions_only():
    """Changing the prefix moves the loss; the logits it reads are the
    P + S - 1 text positions (the prefix's own predict nothing)."""
    cfg = registry.get_config("musicgen-large", smoke=True).replace(
        dtype="float32")
    params = tfm.init_params(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
    rng = np.random.default_rng(3)
    batch = {k: torch.tensor(v) for k, v in
             _batch(cfg, rng, prefix=True).items()}
    logits, _, P = tfm.forward(cfg, params, batch["tokens"],
                               prefix_embeds=batch["prefix_embeds"])
    assert P == cfg.modality.prefix_len and logits.shape == (2, P + 12, 4, 256)
    logp = torch.log_softmax(logits[:, P:P + 11], dim=-1)
    want = -torch.gather(logp, -1, batch["tokens"][:, 1:, :, None].long())
    loss, _ = tfm.loss_fn(cfg, params, batch)
    assert float(loss) == pytest.approx(float(want.mean()), rel=1e-6)


# ---------------------------------------------------------------------------
# The flash kernel under autograd
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window,q_offset", [(None, 0), (8, 0), (None, 6)])
def test_flash_function_grads_equal_autograd_through_ref(monkeypatch, dtype,
                                                         window, q_offset):
    """`_FlashAttention` with the kernel's launch stood in by the plain
    version (the CPU has no kernel): one forward launch, and gradients
    equal to autograd through `flash_attention_ref`, for GQA inputs."""
    launched = []

    def stand_in(q, k, v, causal, window, q_offset):
        launched.append(torch.is_grad_enabled())
        return fa_ref.flash_attention_ref(q, k, v, causal, window, q_offset)

    monkeypatch.setattr(fa_ops, "_launch", stand_in)
    g = torch.Generator().manual_seed(7)
    q, k, v = (torch.randn(shape, generator=g).to(dtype) for shape in
               ((2, 20, 4, 32), (2, 20 + q_offset, 2, 32),
                (2, 20 + q_offset, 2, 32)))
    up = torch.randn((2, 20, 4, 32), generator=g).to(dtype)
    qa, ka, va = (t.clone().requires_grad_(True) for t in (q, k, v))
    out = fa_ops._FlashAttention.apply(qa, ka, va, True, window, q_offset)
    assert launched == [False]  # the forward launches once, outside autograd
    assert out.grad_fn is not None
    got = torch.autograd.grad(out, (qa, ka, va), up)
    qb, kb, vb = (t.clone().requires_grad_(True) for t in (q, k, v))
    want_out = fa_ref.flash_attention_ref(qb, kb, vb, True, window, q_offset)
    want = torch.autograd.grad(want_out, (qb, kb, vb), up)
    assert torch.equal(out, want_out.detach())
    for a, b in zip(got, want):
        assert a.dtype == dtype and torch.equal(a, b)
    assert len(launched) == 1  # the backward launches nothing


# ---------------------------------------------------------------------------
# Token data
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("vocab,seed", [(512, 0), (2048, 3)])
def test_token_stream_and_batches_exact(vocab, seed):
    got = make_token_stream(5_000, vocab, seed=seed)
    want = j_synthetic.make_token_stream(5_000, vocab, seed=seed)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    for step in (1, 2, 7):
        a = token_batches(got, 4, 32, step, seed=seed + 1)
        b = j_pipeline.token_batches(want, 4, 32, step, seed=seed + 1)
        assert a.shape == (4, 33) and a.dtype == b.dtype == np.int32
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# adamw
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("weight_decay", [0.0, 0.1])
def test_adamw_20_steps_match_reference(weight_decay):
    rng = np.random.default_rng(4)
    p0 = {"w": rng.normal(0, 1, (3, 4)).astype(np.float32),
          "b": [rng.normal(0, 1, 5).astype(np.float32)]}
    grads = [jax.tree.map(lambda x: rng.normal(0, 1, x.shape).astype(
        np.float32), p0) for _ in range(20)]
    j_opt, t_opt = (f(0.05, weight_decay=weight_decay)
                    for f in (j_adamw, adamw))
    jp, tp = jax.tree.map(jnp.asarray, p0), to_torch(p0, device="cpu")
    js, ts = j_opt.init(jp), t_opt.init(tp)
    assert isinstance(ts, AdamState) and ts.step.dtype == torch.int32
    # A NamedTuple state keeps its type through the port's tree_map (the
    # client steps map over optimizer states).
    assert isinstance(tree_map(lambda t: t[None], ts), AdamState)
    for g in grads:
        u, js = j_opt.update(jax.tree.map(jnp.asarray, g), js, jp)
        jp = j_apply(jp, u)
        u, ts = t_opt.update(to_torch(g, device="cpu"), ts, tp)
        tp = apply_updates(tp, u)
    assert int(ts.step) == int(js.step) == 20
    for a, b in zip(leaves(to_numpy((tp, ts.mu, ts.nu))),
                    jax.tree.leaves((jp, js.mu, js.nu))):
        np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=ADAM_ATOL)


def _quad(params):
    return (torch.sum((params["w"] - 3.0) ** 2)
            + torch.sum(params["b"] ** 2))


@pytest.mark.parametrize("opt_name", ["sgd", "sgd_momentum", "adamw"])
def test_optimizers_converge_quadratic(opt_name):
    """The reference's tests/test_optim_checkpoint.py check, on the port."""
    opt = {"sgd": sgd(0.1), "sgd_momentum": sgd(0.05, momentum=0.9),
           "adamw": adamw(0.3)}[opt_name]
    params = {"w": torch.zeros(4), "b": torch.ones(3)}
    state = opt.init(params)
    for _ in range(150):
        p = tree_map(lambda t: t.detach().requires_grad_(True), params)
        grads = torch.autograd.grad(_quad(p), leaves(p))
        grads = dict(zip(sorted(p), grads))
        updates, state = opt.update(grads, state, params)
        params = apply_updates(params, updates)
    assert float(_quad(params)) < 1e-3


def test_adamw_weight_decay_shrinks():
    opt = adamw(0.01, weight_decay=0.5)
    params = {"w": torch.full((4,), 10.0)}
    state = opt.init(params)
    updates, state = opt.update({"w": torch.zeros(4)}, state, params)
    assert float(updates["w"][0]) < 0  # decay pulls toward zero


# ---------------------------------------------------------------------------
# launch/train.py
# ---------------------------------------------------------------------------

TRAIN_ARGV = ["--smoke", "--rounds", "2", "--clients", "2", "--batch", "2",
              "--seq", "32", "--V", "2", "--defl"]


def test_train_matches_reference_train_main(monkeypatch, capsys):
    monkeypatch.setattr(j_train, "get_config", lambda arch, smoke=False: (
        j_registry.get_config(arch, smoke).replace(dtype="float32")))
    # The reference's own records: each client's V losses and each round's
    # Eq. 8 time, taken from inside its run.
    j_losses, j_round_times = [], []
    make = j_train.make_local_update

    def recording_make(loss_fn, opt):
        inner = make(loss_fn, opt)

        def local_update(*a):
            out = inner(*a)
            j_losses.append(np.asarray(out[2]))
            return out

        return local_update

    round_time = j_train.delay.round_time

    def recording_round_time(*a, **kw):
        j_round_times.append(round_time(*a, **kw))
        return j_round_times[-1]

    monkeypatch.setattr(j_train, "make_local_update", recording_make)
    monkeypatch.setattr(j_train.delay, "round_time", recording_round_time)
    j_params = j_train.main(TRAIN_ARGV)
    j_out = capsys.readouterr().out

    cfg = j_train.get_config("qwen2-0.5b", smoke=True)
    init = to_torch(jax.tree.map(np.asarray, j_tfm.init_params(
        cfg, jax.random.PRNGKey(0))), device="cpu")
    res = train.run(TRAIN_ARGV + ["--device", "cpu"], params=init,
                    cfg=registry.get_config("qwen2-0.5b", smoke=True).replace(
                        dtype="float32"))
    t_out = capsys.readouterr().out

    plan = [ln for ln in j_out.splitlines() if ln.startswith("DEFL plan:")]
    assert plan == [res.plan_line] and res.plan_line in t_out
    sim, total = [], 0.0
    for t in j_round_times:
        total += t
        sim.append(total)
    assert res.sim_time == sim
    field = re.compile(r"sim_time=\s*(\S+)s")
    assert field.findall(t_out) == field.findall(j_out) != []
    assert len(res.losses) == 2 and res.losses[0].shape == (2, 2)
    np.testing.assert_allclose(np.concatenate(res.losses),
                               np.stack(j_losses), rtol=LOSS_RTOL)
    _leaf_close(res.params, j_params, PARAM_TOL)


def test_train_refuses_audio_and_other_device_params():
    with pytest.raises(ValueError, match="codebook"):
        train.run(["--arch", "musicgen-large", "--smoke", "--device", "cpu"])
    meta = {"w": torch.zeros(2, device="meta")}
    with pytest.raises(ValueError, match="params on meta"):
        train.run(["--smoke", "--device", "cpu"], params=meta)


def test_train_main_runs_on_cpu():
    """The reference's test_train_driver_runs_rounds, on the port."""
    params = train.main(["--smoke", "--rounds", "2", "--clients", "2",
                         "--batch", "2", "--seq", "32", "--V", "2",
                         "--device", "cpu"])
    assert all(bool(torch.isfinite(t).all()) for t in leaves(params))
