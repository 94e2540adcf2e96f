"""Dry run: every (architecture x input shape) pair on the production
meshes, counted without a device, with its roofline inputs on the
H100's numbers.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all \\
      --shape all --mesh single --out experiments/dryrun_torch

The port's stand-in for the reference's lower + compile on 512 CPU
placeholders (repro/launch/dryrun.py):

- `jax.eval_shape` / `ShapeDtypeStruct` -> fake tensors
  (torch._subclasses.fake_tensor.FakeTensorMode): shapes and dtypes, no
  storage. Nothing is allocated, no CUDA is initialised and no process
  group is made; the kernel wrappers see CPU fake tensors and take their
  plain versions (the selective scan its shape-only path).
- lower + compile -> one eager run of the port's own step at the pair's
  global shapes, through its entry points: `transformer.prefill`;
  `transformer.decode_step` against `init_cache`; for a train pair
  `transformer.loss_fn` and its backward for ONE client's local step (b =
  B / C sequences), scaled by V steps and C clients. The port has no
  remat (models/transformer.py), so the counted train FLOPs are always
  forward + 2x backward; `--no-remat` changes only the analytic model's
  4x/3x factor (launch/postprocess.py).
- `cost_analysis()` -> torch.utils.flop_counter.FlopCounterMode for the
  FLOPs (matmul-class ops only: an elementwise op counts 0) and
  `_ByteCounter` for the bytes: every non-view op reads each distinct
  tensor argument once and writes each distinct output once. That is
  eager, unfused traffic of the plain versions the wrappers take on fake
  tensors (flash attention's included: its float32 S x S scores are
  written and read again), far more than the kernels move. The one
  exception is the selective scan, which has no plain run on a fake
  tensor: its shape-only op counts its least traffic, each input read
  once and y and h written once (the backward likewise). Both counts are
  global and spread evenly over the mesh's devices. Each record holds the
  counted FLOPs over `utils/analytic.analytic_costs` (`flops_vs_analytic`)
  and over `analytic_flops_as_run`, the same model of the step run here
  (`flops_vs_analytic_as_run`).
- `NamedSharding` shard shapes -> the spec rules applied to shapes
  (sharding/specs.py).
- `memory_analysis()` -> `argument_bytes` and `output_bytes` per device
  from the specs; `temp_bytes` and `peak_bytes` are None (eager PyTorch
  has no compile-time memory analysis).
- the HLO collective parse -> `utils/hlo.fedavg_collectives`, the FedAvg
  sync of a train pair from its spec tree (no HLO exists to parse), for
  `--aggregation` allreduce_shardmap (the default: the sharded
  simulator's partial sums and one all-reduce), int8_shardmap or
  allreduce; serve pairs list none (launch/postprocess.py adds the
  analytic in-loop tensor-parallel traffic to every pair).

A failing pair makes the run exit nonzero.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
import traceback
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode
from torch.utils._pytree import tree_leaves

from repro_torch.configs.base import (INPUT_SHAPES, InputShape, MeshConfig,
                                      ModelConfig)
from repro_torch.configs.registry import ARCH_IDS, get_config
from repro_torch.launch.mesh import Mesh, make_production_mesh
from repro_torch.launch.specs_inputs import (TensorSpec, adapt_config,
                                             decode_input_specs,
                                             prefill_input_specs,
                                             train_input_specs)
from repro_torch.models import transformer as tfm
from repro_torch.sharding.specs import (batch_spec, cache_specs, param_specs,
                                        sharded_bytes)
from repro_torch.utils import flops as fl
from repro_torch.utils.analytic import analytic_costs, analytic_flops_as_run
from repro_torch.utils.hlo import (CROSS_RANK_AGGREGATIONS, CollectiveOp,
                                   collective_summary, fedavg_collectives)
from repro_torch.utils.tree import leaves, tree_map

DEFAULT_V = 4  # baseline local rounds per sync (DEFL hillclimbs this)

# Ops that move no data: allocations, and a view that aten does not mark
# as one.
_NO_TRAFFIC = {torch.ops.aten.empty.memory_format,
               torch.ops.aten.empty_strided.default,
               torch.ops.aten.empty_like.default,
               torch.ops.aten.new_empty.default,
               torch.ops.aten._unsafe_view.default}


class _ByteCounter(TorchDispatchMode):
    """Bytes of eager, unfused traffic: each op that makes a tensor, other
    than a view or an allocation, reads each distinct tensor argument once
    and writes each distinct output once (an in-place op's target counts
    once). Metadata queries (prim ops such as `prim.device`, which fake
    tensors dispatch) make no tensor and count nothing."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.is_view or func in _NO_TRAFFIC or func.namespace == "prim":
            return out
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        if not outs:
            return out
        seen = set()
        for t in tree_leaves((args, kwargs)) + outs:
            if isinstance(t, torch.Tensor) and id(t) not in seen:
                seen.add(id(t))
                self.bytes += t.numel() * t.element_size()
        return out


@dataclass
class Lowered:
    """What one fake run of a pair's step counted, and what its specs
    give one device."""
    flops_global: float
    bytes_global: float
    argument_bytes: int
    output_bytes: int
    collectives: List[CollectiveOp]
    method: str


def _count(fn) -> Tuple[object, float, float]:
    """(fn(), FLOPs, bytes) of one call on fake tensors."""
    with FlopCounterMode(display=False) as fc, _ByteCounter() as bc:
        out = fn()
    return out, float(fc.get_total_flops()), float(bc.bytes)


def _fake(spec_tree):
    """Fake tensors for a tree of TensorSpecs (inside FakeTensorMode)."""
    return tree_map(lambda s: torch.empty(s.shape, dtype=s.dtype), spec_tree)


def _abstract_params(cfg: ModelConfig):
    """The port's init_params tree on fake tensors (inside FakeTensorMode):
    drawn one scan group deep, its stacked (1, sg, ...) layer leaves then
    widened to (G, sg, ...). A fake op costs about as much as a small real
    one, and a full-depth draw makes thousands (the leaves' shapes are the
    same either way: tests/test_torch_sharding_specs.py holds them to the
    reference's)."""
    G = cfg.n_scan_groups
    params = tfm.init_params(cfg.replace(n_layers=cfg.scan_group),
                             torch.Generator(), device="cpu")
    params["layers"] = tree_map(
        lambda t: torch.empty((G, *t.shape[1:]), dtype=t.dtype),
        params["layers"])
    return params


def _batch_axes(mesh: Mesh, mesh_cfg: MeshConfig, B: int) -> tuple:
    """The client axes a batch of B shards over, or () when B does not
    divide over them."""
    axes = tuple(mesh_cfg.client_axes)
    return axes if B % math.prod(mesh.shape[a] for a in axes) == 0 else ()


def _batch_bytes(tree, mesh: Mesh, axes: tuple) -> int:
    specs = tree_map(lambda t: batch_spec(len(t.shape), axes), tree)
    return sharded_bytes(tree, specs, mesh)


def lower_train(cfg: ModelConfig, shape: InputShape, mesh: Mesh,
                mesh_cfg: MeshConfig, V: int = DEFAULT_V,
                aggregation: str = CROSS_RANK_AGGREGATIONS[0]) -> Lowered:
    C = mesh_cfg.n_clients
    inputs = train_input_specs(cfg, shape, mesh_cfg, V)
    params = _abstract_params(cfg)
    params_C = tree_map(lambda t: TensorSpec((C, *t.shape), t.dtype), params)
    pspecs = param_specs(params_C, mesh, client_axes=mesh_cfg.client_axes)
    # One client's local step: its (b, S, ...) slice of the batches.
    step = _fake(tree_map(lambda s: TensorSpec(s.shape[2:], s.dtype),
                          inputs["batches"]))
    for t in leaves(params):
        t.requires_grad_()

    def run():
        loss, _ = tfm.loss_fn(cfg, params, step, impl="kernel")
        loss.backward()

    _, flops, nbytes = _count(run)
    axes = tuple(mesh_cfg.client_axes)
    params_bytes = sharded_bytes(params_C, pspecs, mesh)
    arg = (params_bytes + _batch_bytes(inputs["batches"], mesh, axes)
           + sharded_bytes(inputs["weights"], (None,), mesh))
    out = params_bytes + 4  # params, loss
    return Lowered(
        flops_global=flops * V * C, bytes_global=nbytes * V * C,
        argument_bytes=arg, output_bytes=out,
        collectives=fedavg_collectives(params_C, pspecs, mesh, axes,
                                       aggregation),
        method=(f"one client's loss_fn + backward at its (b, S) = "
                f"{tuple(step['tokens'].shape[:2])}, x V={V} x C={C}; no "
                f"remat (forward + 2x backward)"))


def lower_prefill(cfg: ModelConfig, shape: InputShape, mesh: Mesh,
                  mesh_cfg: MeshConfig) -> Lowered:
    inputs = prefill_input_specs(cfg, shape)
    axes = _batch_axes(mesh, mesh_cfg, shape.global_batch)
    params = _abstract_params(cfg)
    pspecs = param_specs(params, mesh, client_axes=None)
    batch = _fake(inputs)
    (logits, cache), flops, nbytes = _count(lambda: tfm.prefill(
        cfg, params, batch["tokens"], max_len=shape.seq_len, impl="kernel",
        prefix_embeds=batch.get("prefix_embeds")))
    arg = sharded_bytes(params, pspecs, mesh) + _batch_bytes(inputs, mesh,
                                                             axes)
    out = (_batch_bytes(logits, mesh, axes)
           + sharded_bytes(cache, cache_specs(cache, mesh, axes or None),
                           mesh))
    return Lowered(flops, nbytes, arg, out, [],
                   "prefill at the global shape, logits of the last "
                   "position")


def lower_decode(cfg: ModelConfig, shape: InputShape, mesh: Mesh,
                 mesh_cfg: MeshConfig) -> Lowered:
    B = shape.global_batch
    axes = _batch_axes(mesh, mesh_cfg, B)
    inputs = decode_input_specs(cfg, shape)
    params = _abstract_params(cfg)
    pspecs = param_specs(params, mesh, client_axes=None)
    cache = tfm.init_cache(cfg, B, shape.seq_len, device="cpu")
    cspecs = cache_specs(cache, mesh, batch_axes=axes or None)
    cache_bytes = sharded_bytes(cache, cspecs, mesh)
    batch = _fake(inputs)
    (logits, _), flops, nbytes = _count(lambda: tfm.decode_step(
        cfg, params, cache, batch["tokens"]))
    arg = (sharded_bytes(params, pspecs, mesh) + cache_bytes
           + _batch_bytes(inputs, mesh, axes))
    # The logits are replicated, as the reference's out_shardings say.
    out = logits.numel() * logits.element_size() + cache_bytes
    return Lowered(flops, nbytes, arg, out, [],
                   "one decode_step against init_cache's full-length cache")


def lower_pair(arch: str, shape_name: str, mesh: Mesh, mesh_cfg: MeshConfig,
               V: int = DEFAULT_V, remat: bool = True, capacity: float = 0.0,
               dispatch: str = "",
               aggregation: str = CROSS_RANK_AGGREGATIONS[0],
               ) -> Tuple[Lowered, ModelConfig]:
    """One fake run of the pair's step (the reference's lower + compile).
    Returns (Lowered, the config it ran)."""
    cfg = get_config(arch)
    shape = INPUT_SHAPES[shape_name]
    cfg = adapt_config(cfg, shape)
    if not remat:
        cfg = cfg.replace(remat=False)
    if capacity and cfg.moe:
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe,
                                                  capacity_factor=capacity))
    if dispatch and cfg.moe:
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, dispatch=dispatch))
    with FakeTensorMode():
        if shape.kind == "train":
            return lower_train(cfg, shape, mesh, mesh_cfg, V,
                               aggregation), cfg
        if shape.kind == "prefill":
            return lower_prefill(cfg, shape, mesh, mesh_cfg), cfg
        return lower_decode(cfg, shape, mesh, mesh_cfg), cfg


def analyse(lowered: Lowered, cfg: ModelConfig, shape: InputShape,
            mesh: Mesh, mesh_cfg: MeshConfig, V: int) -> Dict:
    n_dev = mesh.size
    flops_dev = lowered.flops_global / n_dev
    bytes_dev = lowered.bytes_global / n_dev
    memory = {"argument_bytes": lowered.argument_bytes,
              "output_bytes": lowered.output_bytes,
              "temp_bytes": None, "peak_bytes": None}
    csum = collective_summary(lowered.collectives)
    # Roofline terms (seconds) of one device at the H100's constants.
    t_compute = flops_dev / fl.PEAK_FLOPS
    t_memory = bytes_dev / fl.HBM_BW
    t_coll = csum["total_wire_bytes"] / fl.LINK_BW
    terms = {"compute": t_compute, "memory": t_memory, "collective": t_coll}
    dominant = max(terms, key=terms.get)
    V = V if shape.kind == "train" else 1
    mflops = fl.model_flops(cfg, shape, V)
    return {
        "flops_per_device": flops_dev,
        "bytes_per_device": bytes_dev,
        "memory": memory,
        "collectives": csum,
        "terms_seconds": terms,
        "dominant": dominant,
        "model_flops": mflops,
        "flops_global": lowered.flops_global,
        "useful_flops_ratio": (mflops / lowered.flops_global
                               if lowered.flops_global else None),
        "counted": lowered.method,
        "flops_vs_analytic": lowered.flops_global / analytic_costs(
            cfg, shape, mesh_cfg, V=V)["flops_global"],
        "flops_vs_analytic_as_run": lowered.flops_global
        / analytic_flops_as_run(cfg, shape, mesh_cfg, V),
    }


def run_pair(arch: str, shape_name: str, mesh_name: str, out_dir: str,
             V: int = DEFAULT_V, tag: str = "", remat: bool = True, capacity: float = 0.0,
             dispatch: str = "", mesh: Optional[Mesh] = None,
             aggregation: str = CROSS_RANK_AGGREGATIONS[0]) -> Dict:
    """One pair's record (written to `out_dir` unless it is empty). `mesh`
    replaces the production mesh named by `mesh_name` (whose MeshConfig
    still sets the client count)."""
    mesh_cfg = MeshConfig(multi_pod=(mesh_name == "multi"))
    if mesh is None:
        mesh = make_production_mesh(multi_pod=mesh_cfg.multi_pod)
    rec: Dict = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                 "mesh_shape": dict(mesh.shape), "V": V,
                 "aggregation": aggregation, "remat": remat,
                 "capacity": capacity, "dispatch": dispatch, "ok": False}
    t0 = time.time()
    try:
        shape = INPUT_SHAPES[shape_name]
        lowered, cfg = lower_pair(arch, shape_name, mesh, mesh_cfg, V,
                                  remat=remat, capacity=capacity,
                                  dispatch=dispatch, aggregation=aggregation)
        rec["lower_seconds"] = time.time() - t0
        rec.update(analyse(lowered, cfg, shape, mesh, mesh_cfg, V))
        rec["ok"] = True
    except Exception as e:  # a failing pair is recorded, and fails the run
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
    rec["total_seconds"] = time.time() - t0
    rec["cuda_initialized"] = torch.cuda.is_initialized()
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        suffix = f"-{tag}" if tag else ""
        fn = os.path.join(
            out_dir, f"{arch}--{shape_name}--{mesh_name}{suffix}.json")
        with open(fn, "w") as f:
            json.dump(rec, f, indent=1, default=str)
    return rec


def _run_pairs(pairs, out_dir: str, jobs: int, kw: Dict):
    """Each pair's record, in order: in this process for one pair or one
    job, else in `jobs` spawned worker processes (a pair's fake step runs
    on one CPU core)."""
    if jobs <= 1 or len(pairs) <= 1:
        for pair in pairs:
            yield run_pair(*pair, out_dir, **kw)
        return
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor
    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(max_workers=min(jobs, len(pairs)),
                             mp_context=ctx) as ex:
        futures = [ex.submit(run_pair, *pair, out_dir, **kw)
                   for pair in pairs]
        for f in futures:
            yield f.result()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument("--V", type=int, default=DEFAULT_V)
    ap.add_argument("--aggregation", default=CROSS_RANK_AGGREGATIONS[0],
                    choices=CROSS_RANK_AGGREGATIONS,
                    help="the FedAvg sync a train pair plans")
    ap.add_argument("--tag", default="")
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--capacity", type=float, default=0.0)
    ap.add_argument("--dispatch", default="")
    ap.add_argument("--jobs", type=int, default=len(os.sched_getaffinity(0)),
                    help="worker processes, one pair at a time each "
                         "(default: the CPUs this process may use)")
    args = ap.parse_args(argv)

    archs = ARCH_IDS if args.arch == "all" else args.arch.split(",")
    shapes = (list(INPUT_SHAPES) if args.shape == "all"
              else args.shape.split(","))
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]

    pairs = [(arch, shape_name, mesh_name) for mesh_name in meshes
             for arch in archs for shape_name in shapes]
    kw = dict(V=args.V, tag=args.tag, remat=not args.no_remat,
              capacity=args.capacity, dispatch=args.dispatch,
              aggregation=args.aggregation)
    failures = 0
    for rec in _run_pairs(pairs, args.out, args.jobs, kw):
        arch, shape_name, mesh_name = rec["arch"], rec["shape"], rec["mesh"]
        if rec["ok"]:
            t = rec["terms_seconds"]
            print(f"OK   {arch:26s} {shape_name:12s} {mesh_name:6s} "
                  f"run={rec['lower_seconds']:6.1f}s "
                  f"comp={t['compute']:.3e} mem={t['memory']:.3e} "
                  f"coll={t['collective']:.3e} dom={rec['dominant']} "
                  f"arg={rec['memory']['argument_bytes']:.4g}B "
                  f"flops/analytic={rec['flops_vs_analytic']:.4f} "
                  f"(as run {rec['flops_vs_analytic_as_run']:.4f})",
                  flush=True)
        else:
            failures += 1
            print(f"FAIL {arch:26s} {shape_name:12s} {mesh_name:6s} "
                  f"{rec['error']}", flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
