"""Model family `cnn`: McMahan et al.'s FedAvg CNN as repro_torch registers
it (models/cnn.py CNNConfig), in float32 with TF32 off. Everything the
harness takes from a configuration's model comes through its family
(`manifest.family(cfg["family"])`); this module gives the CNN's:

  registry_differences(cfg)  where the program's registered spec no longer
                             runs the configuration's file
  spec_model(cfg)            the model the registered spec is rebuilt with
                             (harness/program.py spec_for)
  param_shapes(model)        leaf shapes in the program's layout
  init_params(cfg, seed, device)  the initial model, drawn from the seed
  reference(cfg, members, data, init, device, rounds, mode, half_batch,
            mean_over)       the plain rounds (reference/fl.py over
                             reference/cnn.py) of each member: [Trace]
  CONTROL                    the mode of the control: TF32
  member_round(cfg, b, V, lanes), member_eval(cfg)
                             useful flops and their least seconds
  peak_flops(cfg)            the card's peak at the model's dtype

Useful work is the products a plain implementation needs, whatever runs
them: per client step the forward, every weight gradient and every input
gradient but the first convolution's (its input is the data); per eval
the forward over the test set; per round FedAvg's weighted sum over the
clients. A product's bytes are its inputs read once and its output
written once. Padding, im2col copies and elementwise work are not
counted, so neither share can pass 100% by doing less than this.
"""
from __future__ import annotations

import numpy as np
import torch

from fedbench.harness import program, yardstick
from fedbench.harness.yardstick import F32
from fedbench.reference import clock, fl

CONTROL = "tf32"


def peak_flops(cfg: dict) -> float:
    """The CNN computes in float32 with TF32 off: the float32 rate outside
    the tensor cores."""
    return yardstick.PEAK_FP32_FLOPS


def spec_model(cfg: dict):
    from repro_torch.models.cnn import CNNConfig
    model = cfg["model"]
    return CNNConfig(name=model["name"], input_hw=tuple(model["input_hw"]),
                     in_channels=model["in_channels"],
                     n_classes=model["n_classes"],
                     conv_channels=tuple(model["conv_channels"]),
                     kernel=model["kernel"], fc_dim=model["fc_dim"])


def registry_differences(cfg: dict) -> list:
    return program.spec_differences(cfg, spec_model(cfg))


def param_shapes(model: dict) -> dict:
    """Leaf shapes in the program's layout (HWIO filters, (in, out) dense
    weights), keyed in sorted leaf order."""
    (h, w), cin = model["input_hw"], model["in_channels"]
    c1, c2 = model["conv_channels"]
    k, fc, nc = model["kernel"], model["fc_dim"], model["n_classes"]
    flat = (h // 4) * (w // 4) * c2
    return {"conv1.b": (c1,), "conv1.w": (k, k, cin, c1),
            "conv2.b": (c2,), "conv2.w": (k, k, c1, c2),
            "fc1.b": (fc,), "fc1.w": (flat, fc),
            "fc2.b": (nc,), "fc2.w": (fc, nc)}


def init_params(cfg: dict, seed: int, device: torch.device) -> dict:
    """He-normal weights and zero biases, drawn from `seed` on `device` in
    one call."""
    shapes = param_shapes(cfg["model"])
    gen = torch.Generator(device=device).manual_seed(seed)
    weights = [k for k in sorted(shapes) if k.endswith(".w")]
    sizes = [int(np.prod(shapes[k])) for k in weights]
    draw = torch.randn(sum(sizes), generator=gen, device=device)
    out, at = {}, 0
    for k, n in zip(weights, sizes):
        s = shapes[k]
        fan_in = s[0] if len(s) == 2 else s[0] * s[1] * s[2]
        out[k] = draw[at:at + n].reshape(s) * (2.0 / fan_in) ** 0.5
        out[k.replace(".w", ".b")] = torch.zeros(
            shapes[k.replace(".w", ".b")], device=device)
        at += n
    return out


def reference(cfg: dict, members: list, data, init: dict,
              device: torch.device, rounds: int, mode=None,
              half_batch: bool = False, mean_over=None) -> list:
    """Each member's first `rounds` plain rounds on the images (x, y) from
    `init`: float32 with TF32 off, or mode "tf32" (the control); the
    faults as fl.run plants them."""
    x, y = data
    xt = torch.as_tensor(x, device=device)
    yt = torch.as_tensor(y, dtype=torch.int64, device=device)
    return [fl.run(m.member, init, xt, yt, cfg["fed"]["lr"], rounds,
                   mode or "float32", half_batch, mean_over)
            for m in members]


def _layers(model: dict):
    """[(name, kind, dict of sizes)] of the CNN, input to output."""
    (h, w), cin = model["input_hw"], model["in_channels"]
    c1, c2 = model["conv_channels"]
    k = model["kernel"]
    flat = (h // 4) * (w // 4) * c2
    return [
        ("conv1", "conv", dict(hw=h * w, k2=k * k, cin=cin, cout=c1)),
        ("conv2", "conv", dict(hw=(h // 2) * (w // 2), k2=k * k, cin=c1,
                               cout=c2)),
        ("fc1", "dense", dict(i=flat, o=model["fc_dim"])),
        ("fc2", "dense", dict(i=model["fc_dim"], o=model["n_classes"])),
    ]


def _products(model: dict, batch: int, train: bool):
    """[(flops, bytes)] of one forward (and with train its backward) over
    `batch` samples."""
    out = []
    for j, (_, kind, s) in enumerate(_layers(model)):
        if kind == "conv":
            flops = 2 * batch * s["hw"] * s["k2"] * s["cin"] * s["cout"]
            x = batch * s["hw"] * s["cin"]
            y = batch * s["hw"] * s["cout"]
            wt = s["k2"] * s["cin"] * s["cout"]
        else:
            flops = 2 * batch * s["i"] * s["o"]
            x, y, wt = batch * s["i"], batch * s["o"], s["i"] * s["o"]
        out.append((flops, F32 * (x + wt + y)))          # forward
        if train:
            out.append((flops, F32 * (x + y + wt)))      # weight gradient
            if j > 0:
                out.append((flops, F32 * (y + wt + x)))  # input gradient
    return out


def forward_flops(model: dict, batch: int) -> int:
    return sum(f for f, _ in _products(model, batch, train=False))


def train_flops(model: dict, batch: int) -> int:
    return sum(f for f, _ in _products(model, batch, train=True))


def member_round(cfg: dict, b: int, V: int, lanes: int):
    """(flops, least seconds) of one member's round: `lanes` clients of V
    steps at batch b, and the FedAvg sum over the lanes."""
    model = cfg["model"]
    n_params = clock.n_params(param_shapes(model))
    prods = _products(model, b, train=True) * (V * lanes)
    prods.append((2 * lanes * n_params, F32 * (lanes * n_params + lanes
                                               + n_params)))
    return (sum(f for f, _ in prods),
            yardstick.least_s(prods, peak_flops(cfg)))


def member_eval(cfg: dict):
    """(flops, least seconds) of one member's eval over the test set."""
    prods = _products(cfg["model"], cfg["n_test"], train=False)
    return (sum(f for f, _ in prods),
            yardstick.least_s(prods, peak_flops(cfg)))
