"""The paper's evaluation model: the FedAvg CNN (McMahan et al. [2]) for
MNIST / CIFAR-10 image classification — two 5x5 conv + pool stages, one
512-unit FC layer, softmax head.

Port of repro/models/cnn.py. The public functions keep the reference's
layouts so parameters carry over as a plain copy (convert.py): images are
NHWC, conv filters HWIO, and fc1 sees the NHWC flatten of the last pool.
Inside the forward the activations run NCHW through `F.conv2d` (filters
permuted to OIHW) and are permuted back to NHWC before the flatten.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import torch
import torch.nn.functional as F


@dataclass(frozen=True)
class CNNConfig:
    name: str
    input_hw: Tuple[int, int]
    in_channels: int
    n_classes: int = 10
    conv_channels: Tuple[int, int] = (32, 64)
    kernel: int = 5
    fc_dim: int = 512

    @property
    def flat_dim(self) -> int:
        h, w = self.input_hw
        return (h // 4) * (w // 4) * self.conv_channels[1]


def mnist_cnn() -> CNNConfig:
    return CNNConfig(name="cnn-mnist", input_hw=(28, 28), in_channels=1)


def mnist_cnn_small() -> CNNConfig:
    """Smoke-scale variant (same topology, ~30x fewer params)."""
    return CNNConfig(name="cnn-mnist-small", input_hw=(28, 28), in_channels=1,
                     conv_channels=(8, 16), fc_dim=64)


def mnist_cnn_tiny() -> CNNConfig:
    """Overhead-scale variant: 1x1 kernels and minimal widths."""
    return CNNConfig(name="cnn-mnist-tiny", input_hw=(28, 28), in_channels=1,
                     conv_channels=(1, 2), kernel=1, fc_dim=8)


def cifar_cnn() -> CNNConfig:
    return CNNConfig(name="cnn-cifar", input_hw=(32, 32), in_channels=3)


def param_shapes(cfg: CNNConfig) -> Dict[str, Dict[str, Tuple[int, ...]]]:
    """Parameter shapes in the reference's layout (HWIO conv filters,
    (in, out) dense weights)."""
    c1, c2 = cfg.conv_channels
    k = cfg.kernel
    return {
        "conv1": {"w": (k, k, cfg.in_channels, c1), "b": (c1,)},
        "conv2": {"w": (k, k, c1, c2), "b": (c2,)},
        "fc1": {"w": (cfg.flat_dim, cfg.fc_dim), "b": (cfg.fc_dim,)},
        "fc2": {"w": (cfg.fc_dim, cfg.n_classes), "b": (cfg.n_classes,)},
    }


def init_cnn(cfg: CNNConfig, seed: int, device: torch.device) -> Dict:
    """He-normal weights and zero biases, as the reference draws them (the
    values differ: torch's generator is not JAX's threefry). Drawn on the
    CPU from `seed`, so every device starts from the same model."""
    gen = torch.Generator().manual_seed(seed)
    params = {}
    for name, shapes in param_shapes(cfg).items():
        shape = shapes["w"]
        fan_in = shape[0] if name.startswith("fc") else shape[0] * shape[1] * shape[2]
        w = torch.randn(shape, generator=gen) * (2.0 / fan_in) ** 0.5
        params[name] = {"w": w.to(device),
                        "b": torch.zeros(shapes["b"], device=device)}
    return params


def _conv(x: torch.Tensor, p: Dict) -> torch.Tensor:
    """'SAME' conv of NCHW x with an HWIO filter (odd kernel)."""
    k = p["w"].shape[0]
    return F.conv2d(x, p["w"].permute(3, 2, 0, 1), p["b"], padding=k // 2)


def _maxpool(x: torch.Tensor) -> torch.Tensor:
    """Non-overlapping 2x2 max pool as reshape + amax, like the reference:
    amax splits the gradient evenly over ties, as JAX's max does
    (F.max_pool2d would route it all to one element)."""
    B, C, H, W = x.shape
    return x.reshape(B, C, H // 2, 2, W // 2, 2).amax(dim=(3, 5))


def cnn_forward(cfg: CNNConfig, params: Dict, images: torch.Tensor,
                ) -> torch.Tensor:
    """images: (B, H, W, C) -> logits (B, n_classes)."""
    x = images.permute(0, 3, 1, 2)
    x = _maxpool(torch.relu(_conv(x, params["conv1"])))
    x = _maxpool(torch.relu(_conv(x, params["conv2"])))
    x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
    x = torch.relu(x @ params["fc1"]["w"] + params["fc1"]["b"])
    return x @ params["fc2"]["w"] + params["fc2"]["b"]


def cnn_loss(cfg: CNNConfig, params: Dict, batch: Dict) -> torch.Tensor:
    """Mean cross-entropy of the batch {'x': (B, H, W, C), 'y': (B,) int64}."""
    return F.cross_entropy(cnn_forward(cfg, params, batch["x"]), batch["y"])
