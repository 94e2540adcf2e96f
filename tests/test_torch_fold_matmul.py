"""The fold matmul's routing, on the CPU: which route each product of the
CNN's local step takes at the FL paths' shapes, that phase 3 of
chip_smoke.py times the main path's own products, and that the wrapper's
table of kernel instances is the kernel source's.

The kernel itself runs on the card only (tests/test_torch_fold_matmul_cuda.py
holds every route to the row route bit for bit there); on CPU tensors the
wrapper is its plain version whatever the route.
"""
import ast
import dataclasses
import re
from pathlib import Path

import pytest
import torch

from repro_torch.federated import experiment
from repro_torch.kernels.fold_matmul import ops
from repro_torch.models import cnn
from repro_torch.utils.tree import tree_map

ROOT = Path(__file__).resolve().parent.parent

# The products of cnn._stacked_value_and_grad, in the order it issues them.
PRODUCTS = ("conv1_fwd", "conv2_fwd", "fc1_fwd", "fc2_fwd", "loss_sum",
            "fc2_wgrad", "fc2_bias", "dh", "fc1_wgrad", "fc1_bias", "dflat",
            "conv2_wgrad", "conv2_bias", "conv2_dgrad", "conv1_wgrad",
            "conv1_bias")

# The route of each product class: the convs' products and the dense
# layers' large ones on tiles; long K with few outputs on the panel; short
# K with few rows or columns on rows.
ROUTES = {
    "conv1_fwd": "tiles", "conv2_fwd": "tiles", "conv2_dgrad": "tiles",
    "fc1_wgrad": "tiles", "fc1_fwd": "tiles", "dflat": "tiles",
    "conv1_wgrad": "panel", "conv1_bias": "panel", "conv2_bias": "panel",
    "fc2_fwd": "panel",
    "loss_sum": "rows", "fc2_wgrad": "rows", "fc2_bias": "rows",
    "fc1_bias": "rows",
}

# Fig. 2's Study groups (chip_smoke.py phase 17): 2 seeds x 3 arms x 10
# clients on the stacked axis, each padded to its (V, b) envelope.
FIG2 = {"fig2_mnist": ("mnist_cnn", 60, 32),
        "fig2_cifar": ("cifar_cnn", 60, 64)}


def _config(name):
    """(model, clients on the stacked axis, batch size): the registered
    specs compressed, as chip_smoke.py phases 4 and 10 run them (their
    plan's b*), or a Fig. 2 group's envelope."""
    if name in FIG2:
        return FIG2[name]
    spec = experiment.get(name)
    spec = spec.replace(fed=dataclasses.replace(spec.fed,
                                                compress_updates=True))
    return spec.model, spec.fed.n_devices, spec.resolve_plan().b


def _layout(a, b):
    """chip_smoke.FOLD_CASES' name for the operands' layout."""
    if a.stride() == (0, 0, 0):
        return "ones"
    if a.shape[1] > 1 and a.stride(1) == 1 and a.stride(2) != 1:
        return "tn"
    if b.shape[1] > 1 and b.stride(1) == 1 and b.stride(2) != 1:
        return "nt"
    return "nn"


def _products(model, b):
    """{product: (M, K, N, layout)} of one client's local step at batch
    size b, recorded through the `mm` argument (the shapes do not depend
    on the number of clients, which is the product's batch)."""
    cfg = getattr(cnn, model)()
    params = tree_map(lambda v: v[None], cnn.init_cnn(cfg, 0, "cpu"))
    g = torch.Generator().manual_seed(0)
    h, w = cfg.input_hw
    x = torch.rand(1, b, h, w, cfg.in_channels, generator=g)
    y = torch.randint(0, cfg.n_classes, (1, b), generator=g)
    seen = []

    def mm(a, bb):
        seen.append((a.shape[1], a.shape[2], bb.shape[2], _layout(a, bb)))
        return torch.matmul(a, bb)

    cnn._stacked_value_and_grad(cfg, params, {"x": x, "y": y}, None, None,
                                mm)
    assert len(seen) == len(PRODUCTS)
    return dict(zip(PRODUCTS, seen))


@pytest.mark.parametrize("name", ["mnist_paper", "cifar_paper", "fig2_mnist",
                                  "fig2_cifar"])
def test_route_for_gives_each_product_class_its_route(name):
    model, clients, b = _config(name)
    for product, (M, K, N, _) in _products(model, b).items():
        want = ROUTES.get(product)
        if product == "conv2_wgrad":  # fills the card at 60 clients only
            want = "tiles" if clients >= 60 else "panel"
        elif product == "dh":  # (b, 10) @ (10, 512): few rows up to b = 32
            want = "rows" if b <= 32 else "tiles"
        route = ops.route_for(clients, M, N, K)
        assert route == want, (name, product, (clients, M, K, N))
        instance = ops.instance_for(route, clients, M, N)
        if product in ("conv1_bias", "conv2_bias"):
            assert instance == "1x8"
        elif product == "conv2_wgrad":  # M = 800: 7 tiles of 128 rows
            assert instance == "64x64"
        elif product in ("conv1_fwd", "conv2_dgrad", "fc1_wgrad"):
            assert instance == "128x64"
        elif product in ("fc1_fwd", "dflat") and b <= 32:
            assert instance == "16x64"


def _fold_cases():
    """chip_smoke.FOLD_CASES, read from the file without importing it."""
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
                getattr(t, "id", None) == "FOLD_CASES" for t in node.targets):
            return ast.literal_eval(node.value)
    raise AssertionError("chip_smoke.py has no FOLD_CASES")


def test_phase3_times_every_long_k_product_of_the_main_path():
    """Every product of compressed mnist_paper's local step with K >= 512
    is a `paper_*` case of chip_smoke.py's phase 3, of exactly its shape
    and layout."""
    _, clients, b = _config("mnist_paper")
    want = {(clients, M, K, N, layout)
            for M, K, N, layout in _products("mnist_cnn", b).values()
            if K >= 512}
    paper = {k: v for k, v in _fold_cases().items() if k.startswith("paper_")}
    assert len(want) == 8
    assert set(paper.values()) == want


def test_phase3_times_the_sampled_rounds_own_products():
    """The `sampled_*` cases of chip_smoke.py's phase 3 are products of the
    sampled path's local step (phase 19: compressed mnist_paper, K = 50
    lanes of M = 10,000, at that population's plan), of exactly their
    shape and layout, and each takes the route its class takes."""
    spec = experiment.get("mnist_paper")
    spec = spec.replace(
        fed=dataclasses.replace(spec.fed, compress_updates=True),
        population=experiment.PopulationSpec(
            M=10_000, cohort=experiment.CohortSpec(K=50)))
    b = spec.resolve_fed().batch_size
    products = _products("mnist_cnn", b)
    sampled = {k: v for k, v in _fold_cases().items()
               if k.startswith("sampled_")}
    assert set(sampled) == {"sampled_conv2_fwd", "sampled_conv2_wgrad",
                            "sampled_conv1_wgrad"}
    for name, case in sampled.items():
        product = name.removeprefix("sampled_")
        assert case == (50, *products[product]), name
        assert ops.route_for(50, case[1], case[3], case[2]) in (
            "tiles", "panel")


def test_phase3_times_the_async_events_own_products():
    """The `async_*` cases of chip_smoke.py's phase 3 are products of one
    async event's local step (phase 20: compressed mnist_paper on the
    event queue under `stragglers`, at that scenario's plan), at batch 1,
    of exactly their shape and layout: the `loop_*` classes at the async
    path's batch size."""
    spec = experiment.get("mnist_paper")
    spec = spec.replace(
        fed=dataclasses.replace(spec.fed, compress_updates=True),
        scenario="stragglers")
    products = _products("mnist_cnn", spec.resolve_fed().batch_size)
    cases = _fold_cases()
    mine = {k: v for k, v in cases.items() if k.startswith("async_")}
    assert {k.removeprefix("async_") for k in mine} == {
        k.removeprefix("loop_") for k in cases if k.startswith("loop_")}
    for name, case in mine.items():
        assert case == (1, *products[name.removeprefix("async_")]), name


def test_instances_are_the_kernel_sources():
    """ops.INSTANCES lists the .cu's FOLD_INSTANCES, in its id order."""
    src = ops.SOURCE.read_text()
    table = src[src.index("#define FOLD_INSTANCES"):]
    table = table[:table.index("\n\n")]
    got = [tuple(map(int, m)) for m in re.findall(
        r"X\((\d+), (\d+), (\d+), (\d+), (\d+), (\d+), (\d+)\)", table)]
    assert got == [(i, *v) for i, v in enumerate(ops.INSTANCES.values())]


@pytest.mark.parametrize("route,batch,M,N,want", [
    ("rows", 10, 16, 512, "rows"),
    ("tiles", 60, 32, 3136, "16x64"),
    ("tiles", 60, 6272, 64, "128x64"),  # conv2's forward: 12 waves
    ("tiles", 60, 800, 64, "64x64"),  # conv2's weight gradient: 2 waves
    ("tiles", 10, 3136, 800, "128x64"),  # conv2's input gradient
    ("panel", 10, 1, 64, "1x8"),
    ("panel", 10, 25, 32, "32x8"),
    ("panel", 10, 800, 64, "64x64"),
])
def test_instance_for_each_route(route, batch, M, N, want):
    assert ops.instance_for(route, batch, M, N) == want


def test_instance_for_refuses_an_unknown_route():
    with pytest.raises(ValueError, match="no route"):
        ops.instance_for("split_k", 10, 16, 16)
