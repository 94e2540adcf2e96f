"""A configuration of another model family is new files only. A stub family
and a stub kind, defined here, train a toy next-token model in plain torch
(parameters three dicts deep, token data, FedAvg over three clients,
records, useful work and a bf16 peak of their own) and run through the
harness's whole run (cell.run_cell) with manifest.family and
manifest.kind pointed at them: `correct` holds, a planted half-batch step
is caught, `mfu` reads against the stub's peak, and no file of the
harness names the stub. Every configuration of BENCHMARK.json names a
family that gives what the harness takes; one that names none is
refused; and the harness neither imports the CNN's reference nor names
the CNN's sizes."""
import ast
import json
import time
import types
from dataclasses import dataclass

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.func import grad_and_value, vmap

from fedbench.harness import cell, manifest, program, yardstick
from fedbench.harness.common import RefMember, Run
from fedbench.reference.rounds import Member, Trace, norms

CLIENTS, ROWS, B, V = 3, 12, 4, 2
CFG = {"name": "toy", "family": "toy_lm",
       "model": {"vocab": 11, "dim": 8, "depth": 2, "seq": 6},
       "fed": {"lr": 0.5, "n_devices": CLIENTS}, "n_test": 8}
TRAFFIC = {"kind": "toy_fedavg", "rounds_per_call": 1, "eval_every": 1,
           "check_rounds": 2, "compress": False}
LIMITS = {"limits": {"plan_mismatch": 0, "record_mismatch": 0,
                     "nonfinite_loss": 0, "loss_gap": 1e-5,
                     "step1_gap": 1e-4, "stepn_gap": 1e-4,
                     "stepn_total_gap": 1e-5}}
BENCH = {"workloads": [{"name": "toy.fedavg3", "config": "toy",
                        "traffic": "toy_fedavg", "chips": 1}],
         "end_to_end": [], "per_layer": []}
SEED = 2 ** 31 + 17

# The harness's files, which a new family may not need to change.
HARNESS = (sorted((manifest.BENCH / "harness").glob("*.py"))
           + [manifest.BENCH / "run.py", manifest.BENCH / "calibrate.py"])


# The stub family: the model, its data, its plain reference round and its
# useful work.

def toy_shapes(model):
    d, v = model["dim"], model["vocab"]
    out = {"embed.w": (v, d), "head.w": (d, v)}
    for i in range(model["depth"]):
        out[f"blocks.{i}.mlp.w"] = (d, d)
        out[f"blocks.{i}.mlp.b"] = (d,)
    return dict(sorted(out.items()))


def toy_init(cfg, seed, device):
    shapes = toy_shapes(cfg["model"])
    gen = torch.Generator(device=device).manual_seed(seed)
    sizes = [int(np.prod(s)) for s in shapes.values()]
    draw = torch.randn(sum(sizes), generator=gen, device=device) * 0.3
    return {k: t.reshape(s) for (k, s), t in
            zip(shapes.items(), draw.split(sizes))}


def toy_loss(p, tokens, depth, bf16=False):
    """Next-token cross-entropy of a residual stack of tanh MLPs."""
    if bf16:
        p = {k: v.to(torch.bfloat16).float() for k, v in p.items()}
    h = F.embedding(tokens[:, :-1], p["embed.w"])
    for i in range(depth):
        h = h + torch.tanh(h @ p[f"blocks.{i}.mlp.w"]
                           + p[f"blocks.{i}.mlp.b"])
    logits = h @ p["head.w"]
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           tokens[:, 1:].reshape(-1))


def toy_data(cfg, seed):
    m = cfg["model"]
    rng = np.random.default_rng(seed)
    return rng.integers(0, m["vocab"], (CLIENTS * ROWS, m["seq"]))


def batch_rows(c, r, v):
    """Client c's rows of round r's step v: its rows in turn."""
    return c * ROWS + ((r * V + v) * B) % ROWS + np.arange(B)


def toy_record(r, cfg):
    """Round r's (round, sim_time, T_cm, T_cp, uplink_bits,
    n_participants): a fixed toy clock."""
    T_cm, T_cp = 0.25, 0.01 * B
    bits = 32.0 * CLIENTS * sum(int(np.prod(s)) for s in
                                toy_shapes(cfg["model"]).values())
    return (r, r * (T_cm + V * T_cp), T_cm, T_cp, bits, CLIENTS)


def toy_reference(cfg, members, data, init, device, rounds, mode=None,
                  half_batch=False, mean_over=None):
    tokens = torch.as_tensor(data, device=device)
    depth, lr = cfg["model"]["depth"], cfg["fed"]["lr"]
    step = vmap(grad_and_value(
        lambda p, t: toy_loss(p, t, depth, bf16=mode == "bf16")))
    out = []
    for m in members:
        glob = dict(init)
        losses, changes = [], {}
        for r in range(rounds):
            p = {k: v.expand(CLIENTS, *v.shape) for k, v in glob.items()}
            total = torch.zeros(CLIENTS, device=device)
            for v in range(m.V):
                idx = np.stack([batch_rows(c, r, v) for c in range(CLIENTS)])
                if half_batch:
                    idx = idx[:, :B // 2]
                grads, lv = step(p, tokens[idx])
                p = {k: p[k] - lr * grads[k] for k in p}
                total = total + lv
            glob = {k: t.mean(0) for k, t in p.items()}
            losses.append(float((total / m.V).mean()))
            changes[r + 1] = norms({k: glob[k] - init[k] for k in glob})
        out.append(Trace(losses=losses, changes=changes))
    return out


def toy_products(cfg, rows, train):
    m = cfg["model"]
    n = rows * (m["seq"] - 1)
    weights = m["depth"] * m["dim"] ** 2 + m["dim"] * m["vocab"]
    flops = 2 * n * weights * (3 if train else 1)
    return [(flops, 2 * (weights + n * m["dim"] + n * m["vocab"]))]


def toy_member_round(cfg, b, V, lanes):
    P = sum(int(np.prod(s)) for s in toy_shapes(cfg["model"]).values())
    prods = toy_products(cfg, b, True) * (V * lanes) + [
        (2 * lanes * P, 2 * (lanes * P + P))]
    return (sum(f for f, _ in prods),
            yardstick.least_s(prods, yardstick.PEAK_BF16_FLOPS))


def toy_member_eval(cfg):
    prods = toy_products(cfg, cfg["n_test"], False)
    return (sum(f for f, _ in prods),
            yardstick.least_s(prods, yardstick.PEAK_BF16_FLOPS))


TOY_FAMILY = types.SimpleNamespace(
    registry_differences=lambda cfg: [], param_shapes=toy_shapes,
    init_params=toy_init, reference=toy_reference, CONTROL="bf16",
    member_round=toy_member_round, member_eval=toy_member_eval,
    peak_flops=lambda cfg: yardstick.PEAK_BF16_FLOPS)


# The stub kind: the program (an autograd loop over clients, its global
# model held nested) and the reference's members.

@dataclass
class Rec:
    round: int
    sim_time: float
    T_cm: float
    T_cp: float
    uplink_bits: float
    n_participants: int
    train_loss: float


def _tensors(tree, device):
    return {k: _tensors(v, device) if isinstance(v, dict)
            else torch.as_tensor(v, device=device) for k, v in tree.items()}


class ToyProgram(Run):
    half_batch = False

    def __init__(self, cfg, traffic, seed, device, init):
        self.tokens = torch.as_tensor(toy_data(cfg, seed), device=device)
        self.glob = _tensors(program.nested(init), device)
        self.round = 0
        super().__init__(cfg, traffic, [None], CLIENTS)

    def plans(self):
        return [(B, V)]

    def _advance(self, rounds, eval_every):
        depth, lr = self.cfg["model"]["depth"], self.cfg["fed"]["lr"]
        new = []
        for _ in range(rounds):
            start = program.flat(self.glob)
            ends, total = [], 0.0
            for c in range(CLIENTS):
                p = dict(start)
                for v in range(V):
                    rows = batch_rows(c, self.round, v)
                    if self.half_batch:
                        rows = rows[:B // 2]
                    p = {k: t.detach().requires_grad_(True)
                         for k, t in p.items()}
                    loss = toy_loss(p, self.tokens[rows], depth)
                    grads = torch.autograd.grad(loss, list(p.values()))
                    p = {k: (t - lr * g).detach()
                         for (k, t), g in zip(p.items(), grads)}
                    total += float(loss.detach())
                ends.append(p)
            avg = {k: sum(e[k] for e in ends) / CLIENTS for k in start}
            self.glob = _tensors(program.nested(avg), avg["head.w"].device)
            self.round += 1
            new.append(Rec(*toy_record(self.round, self.cfg),
                           train_loss=total / (CLIENTS * V)))
        return [new]

    def params(self, i):
        return program.flat(self.glob)


def toy_reference_members(cfg, traffic, seed):
    member = Member(b=B, V=V, seed=seed, compress=False,
                    client_rows=lambda c: c * ROWS + np.arange(ROWS),
                    sizes=np.full(CLIENTS, ROWS))

    def records(n):
        return [toy_record(r + 1, cfg) for r in range(n)]
    return [RefMember("run", B, V, member, records)], toy_data(cfg, seed)


TOY_KIND = types.SimpleNamespace(Program=ToyProgram,
                                 reference_members=toy_reference_members)


@pytest.fixture
def toy(monkeypatch):
    family, kind = manifest.family, manifest.kind
    monkeypatch.setattr(manifest, "family", lambda name: TOY_FAMILY
                        if name == CFG["family"] else family(name))
    monkeypatch.setattr(manifest, "kind", lambda name: TOY_KIND
                        if name == TRAFFIC["kind"] else kind(name))


def _run():
    return cell.run_cell("toy.fedavg3", SEED, 0.2, False,
                         torch.device("cpu"), time.perf_counter(),
                         bench=BENCH, cfg=json.loads(json.dumps(CFG)),
                         traffic=dict(TRAFFIC), limits=LIMITS)


def test_a_toy_family_runs_correct_through_the_harness(toy):
    res = _run()
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert res["checks"]["loss_gap"]["value"] < 1e-6


def test_a_half_batch_step_of_the_toy_program_is_not_correct(toy,
                                                             monkeypatch):
    monkeypatch.setattr(ToyProgram, "half_batch", True)
    res = _run()
    assert not res["correct"], res["checks"]


def test_the_toy_control_fails_its_limits(toy):
    """cell.reference runs the family's CONTROL mode (bf16 weights)."""
    device = torch.device("cpu")
    init = toy_init(CFG, 5, device)
    members, ref = cell.reference(TOY_KIND, CFG, TRAFFIC, 5, init, device)
    _, control = cell.reference(TOY_KIND, CFG, TRAFFIC, 5, init, device,
                                mode=TOY_FAMILY.CONTROL)
    got = cell.readings(control, ref, members)
    assert any(got[k] > v for k, v in LIMITS["limits"].items()
               if k in got), got


def test_mfu_reads_against_the_family_peak(toy):
    res = _run()
    ctx = res["ctx"]
    assert ctx["peak_flops"] == yardstick.PEAK_BF16_FLOPS
    calls = res["attempted"] // TRAFFIC["rounds_per_call"]
    f_round, _ = toy_member_round(CFG, B, V, CLIENTS)
    f_eval, _ = toy_member_eval(CFG)
    assert ctx["flops"] == calls * (f_round + f_eval)
    got = manifest.metric("mfu").read(ctx)
    assert got == pytest.approx(
        100.0 * ctx["flops"] / (ctx["window_s"] * yardstick.PEAK_BF16_FLOPS),
        rel=1e-12)
    assert got < 100.0 * ctx["flops"] / (ctx["window_s"]
                                         * yardstick.PEAK_FP32_FLOPS)


def test_no_harness_file_names_the_toy_family():
    for path in HARNESS:
        text = path.read_text().lower()
        assert "toy" not in text, path


def test_every_configuration_names_a_family_that_gives_the_contract():
    bench = manifest.benchmark()
    for entry in bench["configs"]:
        family = manifest.family(manifest.config(bench, entry["name"])
                                 ["family"])
        missing = [n for n in manifest.FAMILY if not hasattr(family, n)]
        assert missing == [], (entry["name"], missing)
    missing = [n for n in manifest.FAMILY if not hasattr(TOY_FAMILY, n)]
    assert missing == []


def test_a_configuration_without_a_family_is_refused(tmp_path, monkeypatch):
    bench = manifest.benchmark()
    entry = bench["configs"][0]
    cfg = json.loads((manifest.ROOT / entry["file"]).read_text())
    del cfg["family"]
    (tmp_path / "fedbench" / "configs").mkdir(parents=True)
    (tmp_path / entry["file"]).write_text(json.dumps(cfg))
    monkeypatch.setattr(manifest, "ROOT", tmp_path)
    with pytest.raises(SystemExit, match="names no model family"):
        manifest.config(bench, entry["name"])


CNN_MODULES = ("fedbench.reference.cnn", "fedbench.reference.fl")
CNN_NAMES = ("_cnn_config", "conv_channels", "input_hw")


def _modules(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
            yield from (f"{node.module}.{a.name}" for a in node.names)


def _words(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Name):
            yield node.id
        elif isinstance(node, ast.Attribute):
            yield node.attr
        elif isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            yield node.name
        elif isinstance(node, ast.arg):
            yield node.arg
        elif isinstance(node, ast.Constant) and isinstance(node.value, str):
            yield node.value


@pytest.mark.parametrize("path", HARNESS, ids=lambda p: p.name)
def test_the_harness_reaches_the_cnn_only_through_its_family(path):
    tree = ast.parse(path.read_text())
    for module in _modules(tree):
        assert not module.startswith(CNN_MODULES), (path.name, module)
    for word in _words(tree):
        assert not any(n in word for n in CNN_NAMES), (path.name, word)
