"""The useful work fedbench counts from the CNN's shapes equals what
torch.utils.flop_counter counts on the plain reference."""
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from fedbench.harness import manifest, program, yardstick
from fedbench.reference import clock, cnn


@pytest.mark.parametrize("config", ["mnist_paper", "cifar_paper"])
@pytest.mark.parametrize("batch", [1, 3])
def test_train_and_forward_flops_match_the_flop_counter(config, batch):
    model = manifest.config(manifest.benchmark(), config)["model"]
    params = program.init_params(clock.param_shapes(model), 0,
                                 torch.device("cpu"))
    for p in params.values():
        p.requires_grad_(True)
    (h, w), c = model["input_hw"], model["in_channels"]
    x = torch.randn(batch, h, w, c)
    y = torch.arange(batch) % model["n_classes"]
    with FlopCounterMode(display=False) as fwd:
        cnn.forward(params, x)
    assert fwd.get_total_flops() == yardstick.forward_flops(model, batch)
    with FlopCounterMode(display=False) as train:
        cnn.loss(params, x, y).backward()
    assert train.get_total_flops() == yardstick.train_flops(model, batch)


def test_published_parameter_counts():
    bench = manifest.benchmark()
    for entry in bench["configs"]:
        cfg = manifest.config(bench, entry["name"])
        assert clock.n_params(cfg["model"]) == cfg["n_params"]


def test_shares_count_less_than_the_work_that_runs():
    """The least time of a round is below its float32 operations at the
    peak (each product bound by operations or bytes), and eval adds to
    it."""
    model = manifest.config(manifest.benchmark(), "mnist_paper")["model"]
    f, t = yardstick.member_round(model, clock.n_params(model), 16, 2, 10)
    assert t >= f / yardstick.PEAK_FP32_FLOPS
    assert f == 16 * 2 * 10 * yardstick.train_flops(model, 1) + \
        2 * 10 * clock.n_params(model)
    assert yardstick.quantize_bytes(1) == 1024 * 9 + 4
