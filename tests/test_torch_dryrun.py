"""The port's dry-run tools against the reference's: utils/analytic.py,
utils/flops.py, launch/specs_inputs.py, utils/hlo.py's wire bytes and
summary, the FedAvg plan, launch/dryrun.py end to end on fake tensors
(qwen2-0.5b decode_32k at full size), launch/postprocess.py read by the
reference's own benchmarks/roofline_table.py, and the selective scan's
shape-only path for fake tensors.

The counted FLOPs of every arch against the analytic model are in
tests/test_torch_dryrun_flops.py; here each of the four departures of
`analytic_flops_as_run` (the model of the step the dry run runs) from
`analytic_costs` is pinned to a figure worked out by hand.
"""
import dataclasses
import importlib
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from benchmarks import roofline_table
from repro.configs import registry as j_registry
from repro.configs.base import INPUT_SHAPES as J_SHAPES
from repro.configs.base import MeshConfig as JMeshConfig
from repro.launch import specs_inputs as j_inputs
from repro.utils import analytic as j_analytic
from repro.utils import flops as j_flops
from repro.utils import hlo as j_hlo
from repro_torch.configs import registry
from repro_torch.configs.base import INPUT_SHAPES, InputShape, MeshConfig
from repro_torch.kernels.selective_scan import ops as ss_ops
from repro_torch.kernels.selective_scan.ref import selective_scan_ref
from repro_torch.launch import dryrun, postprocess, specs_inputs
from repro_torch.launch.mesh import make_production_mesh, make_test_mesh
from repro_torch.utils import analytic, flops, hlo
from repro_torch.utils.tree import leaves_with_path

MESHES = (False, True)
_DTYPES = {jnp.dtype(jnp.int32): torch.int32,
           jnp.dtype(jnp.bfloat16): torch.bfloat16,
           jnp.dtype(jnp.float32): torch.float32}


def _jcfg(arch, shape_name):
    return j_inputs.adapt_config(j_registry.get_config(arch),
                                 J_SHAPES[shape_name])


@pytest.mark.parametrize("arch", registry.ARCH_IDS)
def test_analytic_and_model_flops_equal_the_reference(arch):
    for shape_name, shape in INPUT_SHAPES.items():
        cfg = specs_inputs.adapt_config(registry.get_config(arch), shape)
        j_cfg = _jcfg(arch, shape_name)
        j_shape = J_SHAPES[shape_name]
        for multi in MESHES:
            for remat in (True, False):
                got = analytic.analytic_costs(
                    cfg.replace(remat=remat), shape,
                    MeshConfig(multi_pod=multi), V=4)
                want = j_analytic.analytic_costs(
                    j_cfg.replace(remat=remat), j_shape,
                    JMeshConfig(multi_pod=multi), V=4)
                assert got == want, (shape_name, multi, remat)
        for V in (1, 4):
            assert (flops.model_flops(cfg, shape, V)
                    == j_flops.model_flops(j_cfg, j_shape, V))
            assert (flops.tokens_per_call(cfg, shape, V)
                    == j_flops.tokens_per_call(j_cfg, j_shape, V))


def test_the_h100_constants():
    # NVIDIA H100 80GB HBM3 (SXM5) data sheet at 700 W; no TPU constant.
    assert (flops.PEAK_FLOPS, flops.PEAK_FLOPS_F32, flops.HBM_BW,
            flops.LINK_BW) == (989.4e12, 67e12, 3.35e12, 450e9)
    assert not hasattr(flops, "ICI_BW")
    assert postprocess.fl is flops and dryrun.fl is flops


def _ref_tree(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {tuple(str(k.key) for k in path): (tuple(x.shape),
                                              _DTYPES[jnp.dtype(x.dtype)])
            for path, x in flat}


def _port_tree(tree):
    return {tuple(str(k) for k in path): (tuple(x.shape), x.dtype)
            for path, x in leaves_with_path(tree)}


@pytest.mark.parametrize("arch", registry.ARCH_IDS)
def test_input_specs_equal_the_reference(arch):
    for shape_name, shape in INPUT_SHAPES.items():
        cfg = specs_inputs.adapt_config(registry.get_config(arch), shape)
        j_cfg = _jcfg(arch, shape_name)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(j_cfg)
        j_shape = J_SHAPES[shape_name]
        if shape.kind == "train":
            for multi in MESHES:
                got = specs_inputs.train_input_specs(
                    cfg, shape, MeshConfig(multi_pod=multi), 4)
                want = j_inputs.train_input_specs(
                    j_cfg, j_shape, JMeshConfig(multi_pod=multi), 4)
                assert _port_tree(got) == _ref_tree(want)
        elif shape.kind == "prefill":
            assert (_port_tree(specs_inputs.prefill_input_specs(cfg, shape))
                    == _ref_tree(j_inputs.prefill_input_specs(j_cfg,
                                                              j_shape)))
        else:
            assert (_port_tree(specs_inputs.decode_input_specs(cfg, shape))
                    == _ref_tree(j_inputs.decode_input_specs(j_cfg,
                                                             j_shape)))
    assert specs_inputs.SWA_WINDOW == j_inputs.SWA_WINDOW


OPS = [("all-reduce", "f32", (16, 896), 16), ("all-reduce", "bf16", (3,), 1),
       ("all-gather", "bf16", (4, 1024, 128), 8),
       ("reduce-scatter", "f32", (2, 64), 16), ("all-to-all", "s8", (512,), 4),
       ("collective-permute", "f32", (7, 7), 2)]


def test_wire_bytes_and_summary_equal_the_reference():
    ours, theirs = [], []
    for kind, dt, shape, g in OPS:
        nbytes = int(np.prod(shape)) * hlo._DTYPE_BYTES[dt]
        assert hlo._DTYPE_BYTES[dt] == j_hlo._DTYPE_BYTES[dt]
        assert hlo._wire_bytes(kind, nbytes, g) == j_hlo._wire_bytes(
            kind, nbytes, g)
        ours.append(hlo.CollectiveOp(kind, dt, shape, nbytes, g,
                                     hlo._wire_bytes(kind, nbytes, g)))
        theirs.append(j_hlo.CollectiveOp(kind, dt, shape, nbytes, g,
                                         j_hlo._wire_bytes(kind, nbytes, g)))
    assert hlo._DTYPE_BYTES == j_hlo._DTYPE_BYTES
    assert hlo.collective_summary(ours) == j_hlo.collective_summary(theirs)


def test_fedavg_plan():
    """One float32 all-reduce a client-sharded leaf: its shard with one
    client row, over the product of the client axes."""
    leaf = specs_inputs.TensorSpec
    for multi, g in ((False, 16), (True, 32)):
        mc = MeshConfig(multi_pod=multi)
        mesh = make_production_mesh(multi_pod=multi)
        C = mc.n_clients
        tree = {"w": leaf((C, 64, 32), torch.float32),
                "b": leaf((C, 5), torch.bfloat16)}
        pspecs = {"w": (mc.client_axes if multi else "data", "model", None),
                  "b": (mc.client_axes if multi else "data", None)}
        ops = hlo.fedavg_collectives(tree, pspecs, mesh, mc.client_axes)
        # leaves in sorted-key order: b, then w
        assert [o.shape for o in ops] == [(1, 5), (1, 4, 32)]
        assert [o.bytes for o in ops] == [20, 512]
        assert all(o.kind == "all-reduce" and o.dtype == "f32"
                   and o.group_size == g for o in ops)
        assert [o.wire_bytes for o in ops] == [2 * 20 * (g - 1) / g,
                                               2 * 512 * (g - 1) / g]
    # A leaf not sharded over the clients is not synced.
    assert hlo.fedavg_collectives({"x": leaf((4,), torch.float32)},
                                  {"x": (None,)}, mesh,
                                  mc.client_axes) == []


# The int8_shardmap and allreduce plans of test_fedavg_plan's tree, worked
# out by hand. Per device the 'w' leaf (C, 64, 32) holds (C/g, 4, 32) (the
# 'model' axis of 16 splits 64) and 'b' (C, 5) holds (C/g, 5); C = g = 16
# clients on the single mesh, 32 on the multi-pod one.
#   int8_shardmap: per leaf an s8 all-gather of every client's codes, (C,
#     prod(shard[1:])) at 1 B, and an f32 all-gather of their scales (C, 1):
#     b: 16 x 5 = 80 B and 16 x 4 = 64 B; w: 16 x 128 = 2,048 B and 64 B
#     (multi: 160, 128, 4,096, 128 B);
#   allreduce: per leaf an f32 all-gather of every client's rows (C,
#     *shard[1:]): b (16, 5) = 320 B, w (16, 4, 32) = 8,192 B (multi: 640
#     and 16,384 B).
# An all-gather's wire bytes are its output's x (g - 1) / g.
_PLANS = {
    "int8_shardmap": {
        16: [("all-gather", "s8", (16, 5), 80),
             ("all-gather", "f32", (16, 1), 64),
             ("all-gather", "s8", (16, 128), 2048),
             ("all-gather", "f32", (16, 1), 64)],
        32: [("all-gather", "s8", (32, 5), 160),
             ("all-gather", "f32", (32, 1), 128),
             ("all-gather", "s8", (32, 128), 4096),
             ("all-gather", "f32", (32, 1), 128)]},
    "allreduce": {
        16: [("all-gather", "f32", (16, 5), 320),
             ("all-gather", "f32", (16, 4, 32), 8192)],
        32: [("all-gather", "f32", (32, 5), 640),
             ("all-gather", "f32", (32, 4, 32), 16384)]},
}


@pytest.mark.parametrize("aggregation", sorted(_PLANS))
def test_fedavg_plan_of_the_other_aggregations(aggregation):
    leaf = specs_inputs.TensorSpec
    for multi, g in ((False, 16), (True, 32)):
        mc = MeshConfig(multi_pod=multi)
        mesh = make_production_mesh(multi_pod=multi)
        C = mc.n_clients
        tree = {"w": leaf((C, 64, 32), torch.float32),
                "b": leaf((C, 5), torch.bfloat16)}
        pspecs = {"w": (mc.client_axes if multi else "data", "model", None),
                  "b": (mc.client_axes if multi else "data", None)}
        ops = hlo.fedavg_collectives(tree, pspecs, mesh, mc.client_axes,
                                     aggregation)
        assert [(o.kind, o.dtype, o.shape, o.bytes) for o in ops] == \
            _PLANS[aggregation][g]
        assert all(o.group_size == g for o in ops)
        assert [o.wire_bytes for o in ops] == [
            o.bytes * (g - 1) / g for o in ops]
    with pytest.raises(ValueError, match="unknown aggregation"):
        hlo.fedavg_collectives(tree, pspecs, mesh, mc.client_axes, "int8")


def _argument_bytes_on_one_device(cfg, shape):
    """qwen2-0.5b decode_32k whole on one device: float32 params, the bf16
    KV cache (2 leaves of (G, sg, B, L, KV, hd)), int32 tokens."""
    a = cfg.attention
    cache = 2 * cfg.n_layers * shape.global_batch * shape.seq_len \
        * a.n_kv_heads * a.head_dim * 2
    return cfg.param_count()[0] * 4 + cache + shape.global_batch * 4


def test_one_pair_end_to_end_then_postprocess_and_roofline(tmp_path):
    env = dict(os.environ)
    importlib.reload(dryrun)  # importing sets no variable
    assert dict(os.environ) == env
    rc = dryrun.main(["--arch", "qwen2-0.5b", "--shape", "decode_32k",
                      "--out", str(tmp_path)])
    assert rc == 0
    assert not torch.cuda.is_initialized()
    fn = tmp_path / "qwen2-0.5b--decode_32k--single.json"
    rec = json.loads(fn.read_text())
    assert rec["ok"], rec.get("error")
    assert rec["aggregation"] == "allreduce_shardmap"
    for key in ("ok", "arch", "shape", "mesh", "V", "remat", "capacity",
                "terms_seconds", "dominant", "model_flops",
                "flops_per_device", "bytes_per_device", "memory",
                "useful_flops_ratio"):
        assert key in rec
    assert rec["collectives"]["total_wire_bytes"] == 0.0
    assert rec["memory"]["temp_bytes"] is None
    assert rec["memory"]["peak_bytes"] is None
    assert rec["dominant"] == max(rec["terms_seconds"],
                                  key=rec["terms_seconds"].get)
    # Counted FLOPs over the reference's analytic_costs, and over the
    # model of the step run (a decode step computes every term the model
    # has, so the two agree).
    j_ana = j_analytic.analytic_costs(
        _jcfg("qwen2-0.5b", "decode_32k"), J_SHAPES["decode_32k"],
        JMeshConfig(), V=1)
    assert rec["flops_vs_analytic"] == (rec["flops_global"]
                                        / j_ana["flops_global"])
    assert abs(rec["flops_vs_analytic"] - 1) <= 1e-3
    assert abs(rec["flops_vs_analytic_as_run"] - 1) <= 1e-3
    assert (rec["terms_seconds"]["compute"]
            == rec["flops_per_device"] / flops.PEAK_FLOPS)
    assert (rec["flops_per_device"] * 256 == rec["flops_global"])
    # On a (1, 1) mesh a device holds the whole pair (two layers deep
    # here: chip_smoke.py phase 27 holds the full depth to the card's
    # allocation), and the counted step does not depend on the mesh.
    shape, mc = INPUT_SHAPES["decode_32k"], MeshConfig()
    cfg = specs_inputs.adapt_config(registry.get_config("qwen2-0.5b"),
                                    shape).replace(n_layers=2)
    with FakeTensorMode():
        one = dryrun.lower_decode(cfg, shape, make_test_mesh((1, 1)), mc)
        full = dryrun.lower_decode(cfg, shape, make_production_mesh(), mc)
    assert one.argument_bytes == _argument_bytes_on_one_device(cfg, shape)
    assert one.argument_bytes > full.argument_bytes
    assert (one.flops_global, one.bytes_global) == (full.flops_global,
                                                    full.bytes_global)

    postprocess.main([str(tmp_path)])
    rec = json.loads(fn.read_text())
    assert rec["analytic"] == j_analytic.analytic_costs(
        _jcfg("qwen2-0.5b", "decode_32k"), J_SHAPES["decode_32k"],
        JMeshConfig(), V=1)
    assert rec["terms_analytic_seconds"]["compute"] == (
        rec["analytic"]["flops_per_device"] / flops.PEAK_FLOPS)
    header, rows = roofline_table.run(dryrun_dir=str(tmp_path))
    assert header.startswith("name,arch,shape,mesh")
    assert len(rows) == 1
    row = rows[0]
    assert row[1:4] == ("qwen2-0.5b", "decode_32k", "single")
    assert row[7] == rec["dominant_analytic"]
    assert float(row[8]) == pytest.approx(rec["model_flops"], rel=1e-3)


# (arch, shape, remat, analytic_costs - analytic_flops_as_run) with the
# figure from the configs' numbers: qwen2-0.5b d 896, vocab 151936, 24
# layers; musicgen-large d 2048, vocab 2048, K 4; llava-next-34b d 7168,
# projector e 1024, prefix 1152; zamba2-2.7b 54 layers, d 2560, expand 2,
# head_dim 64, d_state 64, chunk 128; qwen3-moe-30b-a3b 48 layers, d 2048,
# 128 experts top-8, d_ff_expert 768, capacity factor 1.25. Train shapes
# have 16 clients and V = 2.
AS_RUN_CASES = {
    # Logits at the last position only: (B*S - B) * 2 * d * vocab * K.
    "logits_last_position": ("qwen2-0.5b", ("prefill", 512, 2), True,
                             (2 * 512 - 2) * 2 * 896 * 151936),
    "logits_last_position_K_heads": ("musicgen-large", ("prefill", 512, 2),
                                     True, (2 * 512 - 2) * 2 * 2048 * 2048
                                     * 4),
    # The projector, forward and weight gradient, V steps: it adds
    # B * P * 2 * e * d * 2V.
    "vision_projector_train": ("llava-next-34b", ("train", 1152 + 128, 32),
                               False, -(32 * 1152 * 2 * 1024 * 7168 * 2 * 2)),
    # No chunk in a mamba2 decode step: L * B * (2 * chunk * N
    # + 2 * chunk * H * P), H = 2 * 2560 / 64 = 80.
    "mamba2_decode_no_chunk": ("zamba2-2.7b", ("decode", 256, 2), True,
                               54 * 2 * (2 * 128 * 64 + 2 * 128 * 80 * 64)),
    # MoE capacity on b*S = 2 * 128 routed tokens: capacity 24 (int(256 *
    # 8 * 1.25 / 128) = 20, up to a multiple of 8), 12 expert rows a token;
    # the model's on B*S = 4096: capacity 320, 10 rows a token. Each row
    # is 2 * 3 * d * d_ff_expert, over 48 layers, B*S*V tokens, 3 passes.
    "moe_capacity_one_client": ("qwen3-moe-30b-a3b", ("train", 128, 32),
                                False, (10 - 12) * 2 * 3 * 2048 * 768 * 48
                                * (32 * 128 * 2) * 3),
}


@pytest.mark.parametrize("case", sorted(AS_RUN_CASES))
def test_as_run_model_departs_from_analytic_costs_by_hand(case):
    arch, (kind, S, B), remat, figure = AS_RUN_CASES[case]
    cfg = registry.get_config(arch).replace(remat=remat)
    shape, mc = InputShape(kind, S, B, kind), MeshConfig()
    V = 2 if kind == "train" else 1
    gap = (analytic.analytic_costs(cfg, shape, mc, V=V)["flops_global"]
           - analytic.analytic_flops_as_run(cfg, shape, mc, V))
    assert gap == pytest.approx(figure, rel=1e-12, abs=0)


def test_as_run_model_has_no_remat():
    """With remat on, the model's train FLOPs are 4x a forward; the step
    run (no remat) is 3x: exactly 3/4 of it for a dense arch."""
    cfg = registry.get_config("qwen2-0.5b")
    assert cfg.remat
    shape, mc = InputShape("train", 128, 32, "train"), MeshConfig()
    full = analytic.analytic_costs(cfg, shape, mc, V=2)["flops_global"]
    assert (analytic.analytic_flops_as_run(cfg, shape, mc, 2)
            == pytest.approx(full * 3 / 4, rel=1e-12, abs=0))


def test_a_failing_pair_fails_the_run(tmp_path):
    rc = dryrun.main(["--arch", "qwen2-0.5b", "--shape", "no_such_shape",
                      "--out", str(tmp_path)])
    assert rc == 1
    rec = json.loads((tmp_path / "qwen2-0.5b--no_such_shape--single.json"
                      ).read_text())
    assert not rec["ok"] and "KeyError" in rec["error"]


def _scan_inputs(B=2, S=40, D=8, N=4, h0=False):
    rng = np.random.default_rng(0)
    a = [rng.standard_normal((B, S, D)), rng.random((B, S, D)) * 0.1,
         -rng.random((D, N)), rng.standard_normal((B, S, N)),
         rng.standard_normal((B, S, N)), rng.standard_normal(D)]
    if h0:
        a.append(rng.standard_normal((B, D, N)))
    return [torch.tensor(x, dtype=torch.float32) for x in a]


@pytest.mark.parametrize("h0", [False, True])
def test_scan_fake_path_gives_the_plain_versions_shapes(h0):
    real = _scan_inputs(h0=h0)
    kw = {"h0": real[6]} if h0 else {}
    y, h = ss_ops.selective_scan(*real[:6], chunk=16, **kw)
    y_ref, h_ref = selective_scan_ref(*real[:6], chunk=16, **kw)
    assert torch.equal(y, y_ref) and torch.equal(h, h_ref)
    with FakeTensorMode():
        fake = [torch.empty(t.shape).requires_grad_() for t in real]
        kw = {"h0": fake[6]} if h0 else {}
        fy, fh = ss_ops.selective_scan(*fake[:6], chunk=16, **kw)
        assert (fy.shape, fy.dtype) == (y.shape, y.dtype)
        assert (fh.shape, fh.dtype) == (h.shape, h.dtype)
        (fy.sum() + fh.sum()).backward()
        assert [t.grad.shape for t in fake] == [t.shape for t in real]
    assert ss_ops.launches == 0


def test_the_byte_counter_counts_data_movement_only():
    """An elementwise op reads its input and writes its output; views,
    allocations and metadata queries (fake tensors dispatch `prim.device`)
    move nothing; an in-place op's target counts once; the scan's
    shape-only path reads each input once and writes each output once,
    forward and backward."""
    with FakeTensorMode():
        x = torch.empty((4, 8))
        _, flops, nbytes = dryrun._count(lambda: (x.t(), x.view(32),
                                                  torch.empty(3),
                                                  x.new_empty((5,)),
                                                  x.device))
        assert (flops, nbytes) == (0.0, 0.0)
        ins = [torch.empty(t.shape).requires_grad_() for t in _scan_inputs()]
        (y, h), _, nbytes = dryrun._count(
            lambda: ss_ops.selective_scan(*ins, chunk=16))
        size = sum(t.numel() for t in ins) * 4
        assert nbytes == size + (y.numel() + h.numel()) * 4
        gy, gh = torch.empty(y.shape), torch.empty(h.shape)
        _, _, nbytes = dryrun._count(
            lambda: torch.autograd.backward((y, h), (gy, gh)))
        # the saved inputs and the output gradients in, a gradient an
        # input out
        assert nbytes == 2 * size + (y.numel() + h.numel()) * 4
        _, _, nbytes = dryrun._count(lambda: x + 1)
        assert nbytes == 2 * 4 * 8 * 4
        _, _, nbytes = dryrun._count(lambda: x.mul_(2))
        assert nbytes == 4 * 8 * 4
        y = torch.empty((8, 3))
        _, flops, nbytes = dryrun._count(lambda: x @ y)
        assert flops == 2 * 4 * 8 * 3
        assert nbytes == (4 * 8 + 8 * 3 + 4 * 3) * 4
