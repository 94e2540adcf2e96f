"""Counted FLOPs of the port's dry run (launch/dryrun.py) against the
analytic model for the first five archs of the registry (the MoE
family's five: tests/test_torch_dryrun_flops_moe.py, a file of its own so
that the two run side by side under xdist).

FlopCounterMode over one fake step is held to the analytic model of the
step the port runs (`utils/analytic.analytic_flops_as_run`, whose four
departures from `analytic_costs`, the reference's model, are pinned in
tests/test_torch_dryrun.py) at 1e-3 for the attention and MoE archs and
at 1% for the SSM archs, whose scan is elementwise work the counter does
not count and the model does (10 · d_inner · d_state a token and layer).
Train pairs run with remat off: the port has none, so its step is
forward + 2x backward, the model's 3x. These run at every width as
published but one scan group deep, on short sequences (the accounting is
per layer and per token; a fake step's cost is its op count, not its
size).

Every arch's prefill is checked. Decode and train are checked on the
archs whose step differs in kind: dense attention (qwen2-0.5b), mamba1
(falcon-mamba-7b, its train through the scan's shape-only backward),
mamba2 decode without a chunk (zamba2-2.7b), K codebook heads
(musicgen-large), MoE capacity on one client's b·S (qwen3-moe-30b-a3b),
top-1 routing beside a shared expert (llama4-scout-17b-a16e, decode) and
the vision projector (llava-next-34b, train). The other pairs run the
same layer code as one of these at other widths.
"""
import pytest
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.configs import registry as j_registry
from repro.configs.base import InputShape as JInputShape
from repro.configs.base import MeshConfig as JMeshConfig
from repro.utils import analytic as j_analytic
from repro_torch.configs import registry
from repro_torch.configs.base import InputShape, MeshConfig
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.utils import analytic

SSM_ARCHS = ("falcon-mamba-7b", "zamba2-2.7b")
KINDS = ("prefill", "decode", "train")
DECODE_ARCHS = ("qwen2-0.5b", "falcon-mamba-7b", "zamba2-2.7b",
                "musicgen-large", "qwen3-moe-30b-a3b", "llama4-scout-17b-a16e")
TRAIN_ARCHS = ("qwen2-0.5b", "falcon-mamba-7b", "musicgen-large",
               "qwen3-moe-30b-a3b", "llava-next-34b")


def cases(archs):
    """(arch, kind) pairs of `archs` that are checked."""
    return [(a, k) for a in archs for k in KINDS
            if k == "prefill" or a in {"decode": DECODE_ARCHS,
                                       "train": TRAIN_ARCHS}[k]]


def _one_group(arch):
    cfg = registry.get_config(arch).replace(remat=False)
    return cfg.replace(n_layers=cfg.scan_group)


def _short(cfg, kind):
    m = cfg.modality
    P = m.prefix_len if m and m.kind != "audio" else 0
    return {"prefill": InputShape("prefill", 256 + P, 2, "prefill"),
            "decode": InputShape("decode", 256, 2, "decode"),
            "train": InputShape("train", 128 + P, 32, "train")}[kind]


def check_counted_flops(arch, kind):
    cfg = _one_group(arch)
    shape, mc = _short(cfg, kind), MeshConfig()
    mesh = make_production_mesh()
    lower = {"prefill": dryrun.lower_prefill, "decode": dryrun.lower_decode,
             "train": dryrun.lower_train}[kind]
    with FakeTensorMode():
        lowered = (lower(cfg, shape, mesh, mc, V=2) if kind == "train"
                   else lower(cfg, shape, mesh, mc))
    V = 2 if kind == "train" else 1
    want = analytic.analytic_flops_as_run(cfg, shape, mc, V)
    tol = 1e-2 if arch in SSM_ARCHS else 1e-3
    assert abs(lowered.flops_global / want - 1) <= tol, (
        lowered.flops_global, want)
    if arch in SSM_ARCHS:  # the scan's elementwise work is not counted
        assert lowered.flops_global < want
    # The reference's own analytic model at the same config and shape is
    # the base of the as-run figure.
    j_cfg = j_registry.get_config(arch).replace(
        remat=False, n_layers=cfg.n_layers)
    j_shape = JInputShape(shape.name, shape.seq_len, shape.global_batch,
                          shape.kind)
    base = j_analytic.analytic_costs(j_cfg, j_shape, JMeshConfig(), V=V)
    assert base == analytic.analytic_costs(cfg, shape, mc, V=V)
    assert lowered.bytes_global > 0 and lowered.argument_bytes > 0


@pytest.mark.parametrize("arch,kind", cases(registry.ARCH_IDS[:5]))
def test_counted_flops_match_the_analytic_model(arch, kind):
    check_counted_flops(arch, kind)
