"""The card's peaks and the CNN's useful work, counted from its layer
shapes.

Peaks: NVIDIA's H100 SXM5 data sheet at the full 700 W power limit (frozen
copy of repro_torch/utils/flops.py's and chip_smoke.py's constants). The
CNN computes in float32 with TF32 off, so its peak is the float32 rate
outside the tensor cores.

Useful work is the products a plain implementation needs, whatever runs
them: per client step the forward, every weight gradient and every input
gradient but the first convolution's (its input is the data); per eval
the forward over the test set; per round FedAvg's weighted sum over the
clients. A product's bytes are its inputs read once and its output
written once. Padding, im2col copies and elementwise work are not
counted, so neither share can pass 100% by doing less than this.
"""
from __future__ import annotations

PEAK_FP32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12
POWER_LIMIT_W = 700.0
F32 = 4


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


def least_s(products) -> float:
    """The least time the card could take for `products`: each bound by
    its operations or its bytes, whichever is slower (chip_smoke.py's
    `bound`, summed over the products)."""
    return sum(max(f / PEAK_FP32_FLOPS, b / HBM_BYTES_PER_S)
               for f, b in products)


def member_round(model: dict, n_params: int, b: int, V: int, lanes: int):
    """(flops, least seconds) of one member's round: `lanes` clients of V
    steps at batch b, and the FedAvg sum over the lanes."""
    prods = _products(model, b, train=True) * (V * lanes)
    prods.append((2 * lanes * n_params, F32 * (lanes * n_params + lanes
                                               + n_params)))
    return sum(f for f, _ in prods), least_s(prods)


def member_eval(model: dict, n_test: int):
    """(flops, least seconds) of one member's eval over the test set."""
    prods = _products(model, n_test, train=False)
    return sum(f for f, _ in prods), least_s(prods)


def quantize_bytes(rows: int) -> int:
    """A quantize call's bytes over `rows` rows of 1024: float32 values
    and noise read, int8 codes and a float32 scale a row written."""
    return rows * 1024 * (F32 + F32 + 1) + rows * F32
