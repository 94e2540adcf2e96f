"""The useful work fedbench counts from the CNN's shapes (its family,
families/cnn.py) equals what torch.utils.flop_counter counts on the plain
reference."""
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from fedbench.harness import manifest, yardstick
from fedbench.reference import clock, cnn

CNN = manifest.family("cnn")


@pytest.mark.parametrize("config", ["mnist_paper", "cifar_paper"])
@pytest.mark.parametrize("batch", [1, 3])
def test_train_and_forward_flops_match_the_flop_counter(config, batch):
    cfg = manifest.config(manifest.benchmark(), config)
    model = cfg["model"]
    params = CNN.init_params(cfg, 0, torch.device("cpu"))
    for p in params.values():
        p.requires_grad_(True)
    (h, w), c = model["input_hw"], model["in_channels"]
    x = torch.randn(batch, h, w, c)
    y = torch.arange(batch) % model["n_classes"]
    with FlopCounterMode(display=False) as fwd:
        cnn.forward(params, x)
    assert fwd.get_total_flops() == CNN.forward_flops(model, batch)
    with FlopCounterMode(display=False) as train:
        cnn.loss(params, x, y).backward()
    assert train.get_total_flops() == CNN.train_flops(model, batch)


def test_published_parameter_counts():
    bench = manifest.benchmark()
    for entry in bench["configs"]:
        cfg = manifest.config(bench, entry["name"])
        shapes = manifest.family(cfg["family"]).param_shapes(cfg["model"])
        assert clock.n_params(shapes) == cfg["n_params"]


def test_shares_count_less_than_the_work_that_runs():
    """The least time of a round is below its float32 operations at the
    peak (each product bound by operations or bytes), and eval adds to
    it."""
    cfg = manifest.config(manifest.benchmark(), "mnist_paper")
    model = cfg["model"]
    P = clock.n_params(CNN.param_shapes(model))
    f, t = CNN.member_round(cfg, 16, 2, 10)
    assert CNN.peak_flops(cfg) == yardstick.PEAK_FP32_FLOPS
    assert t >= f / yardstick.PEAK_FP32_FLOPS
    assert f == 16 * 2 * 10 * CNN.train_flops(model, 1) + 2 * 10 * P
    assert yardstick.quantize_bytes(1) == 1024 * 9 + 4
