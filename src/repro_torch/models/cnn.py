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
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.func import grad_and_value, vmap

from repro_torch.kernels.fold_matmul.ops import fold_matmul


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


def cnn_loss_masked(cfg: CNNConfig, params: Dict, batch: Dict,
                    sample_mask: torch.Tensor, n: torch.Tensor,
                    ) -> torch.Tensor:
    """`cnn_loss` over the first `n` samples of a batch padded to B_env:
    sample_mask (B_env,) is 1.0 on the valid samples and n (float32) their
    count. A padded row adds an exact 0 to the cross-entropy sum and gets
    a zero logits cotangent, and the sum is divided by n, so the loss and
    its gradient are `cnn_loss`'s on the unpadded batch up to the float32
    summation order (the Study's (V, b) envelope,
    mesh_rounds.envelope_local_steps_fn). The mask selects with
    torch.where, never multiplies: 0 * NaN is NaN."""
    logits = cnn_forward(cfg, params, batch["x"])
    nll = F.cross_entropy(logits, batch["y"], reduction="none")
    return torch.sum(torch.where(sample_mask > 0, nll, 0.0)) / n


# ---------------------------------------------------------------------------
# The stacked, pad- and row-stable gradient (the FL simulator's local step)
# ---------------------------------------------------------------------------
# The simulator trains every client of every member as one stacked client
# axis N. torch.func.vmap of autograd through F.conv2d hands cuDNN a grouped
# convolution whose algorithm, and so whose float32 sums, change with N and
# with the batch length B; a Study member padded to its group's B_env then
# drifts from its run alone, and the drift grows chaotically over a round's
# local steps. The reference keeps its member bit-identical with `_ps_matmul`
# (per-sample filter gradients, then a sum over the batch) and `_seq_mean`.
# The port writes the forward and backward out by hand over the stacked axis
# instead: every product is `fold_matmul` (each output one fma chain over k,
# kernels/fold_matmul), every other step is elementwise, a gather, a max or a
# fixed-order sum, so no sample's numbers depend on N or B, and a weight or
# bias gradient, a K sum over samples with the padded ones last and exactly
# zero, is the same with the padding or without it.


def _patches(x: torch.Tensor, k: int) -> torch.Tensor:
    """'SAME' k x k patches of NHWC x (B, H, W, C) -> (B, H, W, k*k*C),
    ordered as an HWIO filter flattened to (k*k*C, O): the reference's
    im2col."""
    p = k // 2
    H, W = x.shape[1], x.shape[2]
    xp = F.pad(x, (0, 0, p, p, p, p))
    return torch.cat([xp[:, i:i + H, j:j + W, :]
                      for i in range(k) for j in range(k)], dim=-1)


def _patches_grad(d: torch.Tensor, k: int, C: int) -> torch.Tensor:
    """The adjoint of `_patches`: (B, H, W, k*k*C) -> (B, H, W, C), the k*k
    shifted contributions added in a fixed order."""
    p = k // 2
    B, H, W, _ = d.shape
    dxp = d.new_zeros((B, H + 2 * p, W + 2 * p, C))
    for t, (i, j) in enumerate((i, j) for i in range(k) for j in range(k)):
        dxp[:, i:i + H, j:j + W, :] += d[..., t * C:(t + 1) * C]
    return dxp[:, p:p + H, p:p + W, :]


def _pool_nhwc(x: torch.Tensor) -> torch.Tensor:
    B, H, W, C = x.shape
    return x.reshape(B, H // 2, 2, W // 2, 2, C).amax(dim=(2, 4))


def _pool_nhwc_grad(g: torch.Tensor, x: torch.Tensor,
                    pooled: torch.Tensor) -> torch.Tensor:
    """amax's backward: the gradient split evenly over a window's ties."""
    B, H, W, C = x.shape
    xr = x.reshape(B, H // 2, 2, W // 2, 2, C)
    hit = xr == pooled[:, :, None, :, None, :]
    count = hit.sum(dim=(2, 4), keepdim=True)
    return ((g[:, :, None, :, None, :] / count) * hit).reshape(B, H, W, C)


def _fold_sum(x: torch.Tensor, mm) -> torch.Tensor:
    """(N, K, C) -> (N, C): the sum over K as one fma chain (a product with
    a broadcast row of ones)."""
    ones = x.new_ones(()).expand(x.shape[0], 1, x.shape[1])
    return mm(ones, x)[:, 0]


def _stacked_forward(cfg: CNNConfig, params: Dict, x: torch.Tensor, mm):
    """Logits of NHWC images x (N, B, H, W, C) under stacked params (leaves
    (N, ...)), and what the backward needs."""
    N, B, H, W, Cin = x.shape
    k = cfg.kernel
    c1, c2 = cfg.conv_channels
    H2, W2 = H // 2, W // 2
    p1_in = _patches(x.reshape(N * B, H, W, Cin), k).reshape(N, B * H * W, -1)
    z1 = (mm(p1_in, params["conv1"]["w"].reshape(N, -1, c1))
          + params["conv1"]["b"][:, None, :])
    a1 = torch.relu(z1).reshape(N * B, H, W, c1)
    p1 = _pool_nhwc(a1)
    p2_in = _patches(p1, k).reshape(N, B * H2 * W2, -1)
    z2 = (mm(p2_in, params["conv2"]["w"].reshape(N, -1, c2))
          + params["conv2"]["b"][:, None, :])
    a2 = torch.relu(z2).reshape(N * B, H2, W2, c2)
    p2 = _pool_nhwc(a2)
    flat = p2.reshape(N, B, -1)
    hp = mm(flat, params["fc1"]["w"]) + params["fc1"]["b"][:, None, :]
    h = torch.relu(hp)
    logits = mm(h, params["fc2"]["w"]) + params["fc2"]["b"][:, None, :]
    saved = dict(p1_in=p1_in, z1=z1, a1=a1, p1=p1, p2_in=p2_in, z2=z2, a2=a2,
                 p2=p2, flat=flat, hp=hp, h=h)
    return logits, saved


def _stacked_value_and_grad(cfg: CNNConfig, params: Dict, batch: Dict,
                            sample_mask: Optional[torch.Tensor],
                            n: Optional[torch.Tensor], mm):
    """(grads, loss (N,)) of the mean cross-entropy over each client's
    valid samples, written out by hand over the stacked client axis (see
    the block comment above)."""
    x, y = batch["x"], batch["y"]
    N, B, H, W, Cin = x.shape
    k = cfg.kernel
    c1, c2 = cfg.conv_channels
    H2, W2 = H // 2, W // 2
    if sample_mask is None:
        valid = torch.ones((N, B), dtype=torch.bool, device=x.device)
        n = torch.full((N,), float(B), device=x.device)
    else:
        valid = sample_mask > 0
        # A padded sample sees a zero image, so nothing of the gathered
        # one (a NaN included) reaches a product.
        x = torch.where(valid[:, :, None, None, None], x, 0.0)
    logits, s = _stacked_forward(cfg, params, x, mm)
    top = logits.amax(dim=-1, keepdim=True)
    e = torch.exp(logits - top)
    total = e[..., 0]
    for c in range(1, e.shape[-1]):
        total = total + e[..., c]
    lse = torch.log(total) + top[..., 0]
    nll = lse - torch.gather(logits, -1, y[..., None])[..., 0]
    nll = torch.where(valid, nll, 0.0)
    loss = _fold_sum(nll[..., None], mm)[:, 0] / n
    # d loss / d logits: (softmax - onehot) / n on the valid samples.
    cot = torch.where(valid, 1.0 / n[:, None], 0.0)
    d = (e / total[..., None]
         - F.one_hot(y, logits.shape[-1]).to(logits.dtype)) * cot[..., None]
    d = torch.where(valid[..., None], d, 0.0)
    h, flat = s["h"], s["flat"]
    g_fc2 = {"w": mm(h.transpose(1, 2), d), "b": _fold_sum(d, mm)}
    dh = torch.where(s["hp"] > 0, mm(d, params["fc2"]["w"].transpose(1, 2)),
                     0.0)
    g_fc1 = {"w": mm(flat.transpose(1, 2), dh), "b": _fold_sum(dh, mm)}
    dflat = mm(dh, params["fc1"]["w"].transpose(1, 2))
    da2 = _pool_nhwc_grad(dflat.reshape(N * B, H2 // 2, W2 // 2, c2),
                          s["a2"], s["p2"])
    dz2 = torch.where(s["z2"] > 0, da2.reshape(N, B * H2 * W2, c2), 0.0)
    w2 = params["conv2"]["w"]
    g_conv2 = {"w": mm(s["p2_in"].transpose(1, 2), dz2).reshape(w2.shape),
               "b": _fold_sum(dz2, mm)}
    dp2_in = mm(dz2, w2.reshape(N, -1, c2).transpose(1, 2))
    dp1 = _patches_grad(dp2_in.reshape(N * B, H2, W2, -1), k, c1)
    da1 = _pool_nhwc_grad(dp1, s["a1"], s["p1"])
    dz1 = torch.where(s["z1"] > 0, da1.reshape(N, B * H * W, c1), 0.0)
    w1 = params["conv1"]["w"]
    g_conv1 = {"w": mm(s["p1_in"].transpose(1, 2), dz1).reshape(w1.shape),
               "b": _fold_sum(dz1, mm)}
    grads = {"conv1": g_conv1, "conv2": g_conv2, "fc1": g_fc1, "fc2": g_fc2}
    return grads, loss


def cnn_stacked_value_and_grad(cfg: CNNConfig, params: Dict, batch: Dict,
                               sample_mask: Optional[torch.Tensor] = None,
                               n: Optional[torch.Tensor] = None):
    """Every client's gradient and loss over the stacked client axis,
    written out by hand: params leaves (N, ...), batch {'x': (N, B, H, W,
    C), 'y': (N, B)} -> (grads (N, ...), loss (N,)). The loss is
    `cnn_loss`, or with sample_mask (N, B) and n (N,) `cnn_loss_masked`.
    Every product is a fold_matmul (its plain version on CPU tensors), so
    on the card a client's numbers are the same bit for bit whatever N
    and however far its batch is padded."""
    return _stacked_value_and_grad(cfg, params, batch, sample_mask, n,
                                   fold_matmul)


def cnn_value_and_grad(cfg: CNNConfig, params: Dict, batch: Dict,
                       sample_mask: Optional[torch.Tensor] = None,
                       n: Optional[torch.Tensor] = None):
    """The simulator's stacked value-and-grad for the CNN: on the card
    `cnn_stacked_value_and_grad`; on the CPU torch.func's vmap of the
    autograd gradients of `cnn_loss` / `cnn_loss_masked`, which there is
    about twice as fast and no less stable (the plain matmul's sums
    follow the shapes as oneDNN's convolutions do)."""
    if params["fc1"]["w"].device.type == "cuda":
        return cnn_stacked_value_and_grad(cfg, params, batch, sample_mask, n)
    if sample_mask is None:
        return vmap(grad_and_value(lambda p, b: cnn_loss(cfg, p, b)))(
            params, batch)
    return vmap(grad_and_value(lambda p, b, m, k: cnn_loss_masked(
        cfg, p, b, m, k)))(params, batch, sample_mask, n)


def cnn_logits_stacked(cfg: CNNConfig, params: Dict, images: torch.Tensor,
                       ) -> torch.Tensor:
    """Logits of shared NHWC images (T, H, W, C) under stacked params
    (leaves (N, ...)) -> (N, T, n_classes), through the same products as
    `cnn_stacked_value_and_grad`: a member's logits do not depend on N.
    One member at a time, so the patches stay one member's size."""
    out = []
    for i in range(next(iter(params.values()))["w"].shape[0]):
        p = {name: {k: v[i:i + 1] for k, v in leaf.items()}
             for name, leaf in params.items()}
        out.append(_stacked_forward(cfg, p, images[None], fold_matmul)[0])
    return torch.cat(out)
