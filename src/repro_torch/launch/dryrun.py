"""Multi-pod dry run: every (architecture x input shape) cell, priced on the
production meshes without running it.

The counterpart of ``src/repro/launch/dryrun.py``. The reference lowers and
compiles each cell's step for the 16x16 and 2x16x16 meshes and reads XLA's
memory and cost analyses. The port has no compiler to ask, so each cell is
built on the ``meta`` device, where tensors have shapes and no data: nothing
is allocated and nothing is computed, and one process prices a mesh of 512
ranks (``launch.mesh.AbstractMesh``). For each cell it records:

- ``cost_analysis.flops``: ``torch.utils.flop_counter.FlopCounterMode``'s
  count of the products one rank's step runs: the forward (and for a train
  cell the backward) over the rank's rows of the global batch, every layer at
  full width, as the port's steps compute them (the compute over ``model`` is
  not split yet). The counter does not see the ctypes-launched Hopper
  kernels, so the count runs ``attn_impl="xla_chunked"`` and the plain SSM
  scan; decode attends the whole cache on one device and the MoE layers
  route the rank's rows on one device (the mesh dispatch's gathers and
  expert split are not in the count); the recurrences over time, the
  plain SSM scan (with its contraction with C, taken in n order) and
  xLSTM's sLSTM, elementwise and so 0 FLOPs to the counter, are counted so
  without running their loops on meta tensors
  (``kernels.ssm_scan.selective_scan_ref``,
  ``models.xlstm.slstm_recurrence``). The record says so (``count``). ``bytes accessed`` is null: the counter counts no bytes.
- ``memory``: one rank's bytes from the layout's local shapes: the
  parameters' blocks (``registry.param_specs``), for a train cell the AdamW
  moments and any transport state as ``train.step.shardings_for`` lays them
  out, the rank's rows of the batch, and the cache by
  ``serving.steps.cache_shardings``. ``fits_16GB`` keeps the reference's
  meaning, so records compare; ``fits_device`` is against the H100's 80 GB.
  ``working_copy_bytes`` are the bfloat16 serving copies a serve step's
  rank makes (``serving.steps.lay_out``), outside the total: a copy of a
  leaf the serving split reads as the rank's part (``serving.steps.serve_split``:
  its heads, channels, rows of the vocabulary, the moe family's
  ``E/|model|`` experts) at 1/|model|, any other in full.
- ``roofline``: ``analysis.roofline.analyze`` on the H100 table, with the
  collective bytes the port's step sends (``roofline.step_collectives``,
  also under ``collectives`` by ``op@axis``: the compute split's of every
  family, on the sequence-parallel residual where |model| divides S (the
  encoder-decoder's each stack over its own length), and the vocabulary
  split's).
- null, with the reason under ``null_reasons``: ``lower_s``, ``compile_s``
  and ``memory.temp_bytes``, which have no meaning without XLA.

Cells the port cannot run are recorded as skipped with the reason:
``long_500k`` on full-attention archs (``shape_applicable``, as the
reference).

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3.2-1b --shape decode_32k --single-pod
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out results/dryrun
"""
from __future__ import annotations

import argparse
import json
import math
import time
import traceback
from pathlib import Path

import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch import tree as T
from repro_torch.analysis import roofline
from repro_torch.configs import ARCH_IDS, SHAPES, get_config, get_shape, shape_applicable
from repro_torch.configs.base import ShapeConfig, ShardingConfig, TrainConfig
from repro_torch.launch.mesh import HW, AbstractMesh, production_shape
from repro_torch.models import registry
from repro_torch.models.sharding import NamedSharding, batch_axes, kv_partition_mode

#: what the FLOP count runs where the port's step launches a kernel
COUNTED_IMPLS = {"attn_impl": "xla_chunked", "ssm_impl": "jnp"}
NULL_REASONS = {
    "lower_s": "no XLA lowering: the port builds the cell on the meta device",
    "compile_s": "no XLA compile: the port builds the cell on the meta device",
    "memory.temp_bytes": "no compiled buffer assignment: the total counts the layout's "
                         "arguments and outputs only",
    "cost_analysis.bytes accessed": "FlopCounterMode counts products, not bytes; the "
                                    "roofline's memory term is analysis.flops' byte model",
}


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(arch: str, shape_name: str):
    """Meta-tensor stand-ins for every model input of the cell, at the
    reference's global shapes: the batch, and for decode the cache."""
    cfg = get_config(arch)
    shape = get_shape(shape_name)
    specs = {k: _meta(s, dt) for k, (s, dt) in registry.batch_specs(cfg, shape).items()}
    if shape.kind == "decode":
        specs = {"batch": specs, "cache": registry.cache_shapes(cfg, shape)}
    return specs


def _bytes(t) -> int:
    return t.numel() * t.element_size() if isinstance(t, torch.Tensor) else 0


def _working_bytes(model, mesh, sh: ShardingConfig) -> int:
    """The bytes of a serve step's bfloat16 working copies on one rank: each
    ``<name>16`` buffer of the model's parameter ``<name>``, at 1/|model|
    where the serving split reads that parameter as the rank's part."""
    from repro_torch.serving.steps import serve_split

    split = serve_split(model.cfg, mesh, sh)
    m = mesh.shape.get("model", 1)
    total = 0
    for name, buf in model.named_buffers():
        read = split.read_of(name[:-2]) if split is not None and name.endswith("16") else None
        part = read is not None and (read.how == "block" or read.take is not None)
        total += _bytes(buf) // (m if part else 1)
    return total


def _local_bytes(leaf: torch.Tensor, sharding: NamedSharding, dtype=None) -> int:
    size = (dtype or leaf.dtype).itemsize
    return roofline.local_numel(sharding, tuple(leaf.shape)) * size


def _param_state_bytes(model, mesh, sh: ShardingConfig, transport: str, train: bool,
                       tcfg: TrainConfig) -> dict:
    """One rank's parameter blocks, and for training its moments and the
    transport's state, by the layout ``train.step.shardings_for`` builds."""
    from repro_torch.train.step import _zero1_pod

    shapes = registry.param_shapes(model)
    chunnels, specs = roofline.train_layout(model, mesh, sh, transport if train else "xla")
    leaves, p_specs = T.leaves(shapes), T.leaves(specs)
    out = {"params": sum(_local_bytes(l, NamedSharding(mesh, s), torch.float32)
                         for l, s in zip(leaves, p_specs)), "opt": 0, "comm": 0}
    if train:
        opt = getattr(torch, tcfg.opt_dtype)
        out["opt"] = 2 * sum(_local_bytes(l, NamedSharding(mesh, _zero1_pod(s, tuple(l.shape),
                                                                            mesh)), opt)
                             for l, s in zip(leaves, p_specs))
        if any(getattr(ch, "error_feedback", False) for ch in chunnels):
            out["comm"] = out["params"]
    return out


def _cache_bytes(cfg, shape: ShapeConfig, mesh, sh: ShardingConfig) -> int:
    from repro_torch.serving.steps import cache_shardings

    cache = registry.cache_shapes(cfg, shape)
    specs = cache_shardings(cache, cfg, mesh, sh)
    return sum(_local_bytes(l, NamedSharding(mesh, s))
               for (_, l), s in zip(T.flatten_with_paths(cache), T.leaves(specs))
               if isinstance(l, torch.Tensor))


def _count(model, cfg, shape: ShapeConfig, rows: int) -> float:
    """FlopCounterMode's FLOPs of one rank's step on ``rows`` rows."""
    local = ShapeConfig(shape.name, shape.seq_len, rows, shape.kind)
    specs = registry.batch_specs(cfg, local)
    batch = {k: (torch.zeros(s, dtype=dt, device="meta") if not dt.is_floating_point
                 else _meta(s, dt)) for k, (s, dt) in specs.items()}
    with FlopCounterMode(display=False) as fc:
        if shape.kind == "train":
            registry.loss(model, batch).backward()
        elif shape.kind == "prefill":
            extra = {k: v for k, v in batch.items() if k not in ("tokens", "labels")}
            model.prefill(batch["tokens"], **extra)
        else:
            cache = registry.cache_shapes(cfg, local)
            if isinstance(cache, dict) and "len" in cache:
                cache["len"] = shape.seq_len - 1
            model.decode_step(cache, batch["tokens"])
    return float(fc.get_total_flops())


def lower_cell(arch: str, shape_name: str, *, multi_pod: bool,
               transport: str = "xla", moe_dispatch: str | None = None,
               attn_chunk: int | None = None, remat: str | None = None,
               kv_partition: str = "auto"):
    """Price one cell on the meta device; returns the result record."""
    cfg = get_config(arch)
    if moe_dispatch and cfg.moe:
        import dataclasses
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, dispatch=moe_dispatch))
    if attn_chunk:
        cfg = cfg.replace(attn_chunk=attn_chunk)
    if remat:
        cfg = cfg.replace(remat=remat)
    shape = get_shape(shape_name)
    ok, skip_reason = shape_applicable(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape_name, "multi_pod": multi_pod,
                "skipped": True, "reason": skip_reason}

    mesh_shape = production_shape(multi_pod)
    mesh = AbstractMesh(mesh_shape)
    sh = ShardingConfig(pod_transport=transport, kv_partition=kv_partition)
    tcfg = TrainConfig()
    train = shape.kind == "train"
    t0 = time.time()

    n_rows = math.prod(mesh_shape[a] for a in batch_axes(mesh))
    rows = shape.global_batch // n_rows if shape.global_batch % n_rows == 0 else shape.global_batch
    model = registry.build(cfg.replace(attn_impl=COUNTED_IMPLS["attn_impl"]), device="meta")
    if hasattr(model, "ssm_impl"):
        model.ssm_impl = COUNTED_IMPLS["ssm_impl"]
    if train:
        model.release()
    flops = _count(model, model.cfg, shape, rows)

    state = _param_state_bytes(model, mesh, sh, transport, train, tcfg)
    specs = registry.batch_specs(cfg, ShapeConfig(shape.name, shape.seq_len, rows, shape.kind))
    batch_bytes = sum(math.prod(s) * dt.itemsize for s, dt in specs.values())
    logits = rows * cfg.vocab_padded * 2
    if train:
        args = state["params"] + state["opt"] + state["comm"] + batch_bytes
        outputs = state["params"] + state["opt"] + state["comm"] + 2 * 4
        alias = state["params"] + state["opt"] + state["comm"]  # the state is donated
    elif shape.kind == "prefill":
        args = state["params"] + batch_bytes
        outputs = _cache_bytes(cfg, shape, mesh, sh) + logits
        alias = 0
    else:
        cache = _cache_bytes(cfg, shape, mesh, sh)
        args = state["params"] + cache + batch_bytes
        outputs = cache + logits
        alias = 0  # the reference's decode does not donate its cache
    per_dev = args + max(0, outputs - alias)
    working = 0 if train else _working_bytes(model, mesh, sh)

    sent = roofline.step_collectives(cfg, shape, mesh, sh=sh, transport=transport, tcfg=tcfg,
                                     model=model)
    rf = roofline.analyze(sent, cfg, shape, mesh_shape)
    has_kv = cfg.family != "ssm"
    return {
        "arch": arch,
        "shape": shape_name,
        "kind": shape.kind,
        "multi_pod": multi_pod,
        "mesh": mesh_shape,
        "transport": transport,
        "kv_partition": (kv_partition_mode(cfg, mesh, sh)
                         if shape.kind == "decode" and has_kv else None),
        "moe_dispatch": cfg.moe.dispatch if cfg.moe else None,
        "lower_s": None,
        "compile_s": None,
        "count_s": round(time.time() - t0, 2),
        "memory": {
            "argument_bytes": args,
            "output_bytes": outputs,
            "alias_bytes": alias,
            "temp_bytes": None,
            "per_device_total": per_dev,
            "fits_16GB": bool(per_dev < 16e9),
            "fits_device": bool(per_dev < HW["hbm_bytes"]),
            "working_copy_bytes": working,
        },
        "cost_analysis": {"flops": flops, "bytes accessed": None},
        "count": {**COUNTED_IMPLS, "rows": rows,
                  "scope": "one rank's step: its rows, every layer, full width; decode "
                           "attends the whole cache and MoE routes the rank's rows on one "
                           "device",
                  **({"recurrence": "the loop over time (the plain SSM scan, the sLSTM) "
                                    "counted analytically: elementwise, 0 FLOPs; not run"}
                     if cfg.family in ("ssm", "hybrid") else {})},
        "collectives": dict(sent),
        "roofline": rf.to_dict(),
        "null_reasons": NULL_REASONS,
        "skipped": False,
    }


def cell_id(rec) -> str:
    pod = "2pod" if rec["multi_pod"] else "1pod"
    return f"{rec['arch']}__{rec['shape']}__{pod}"


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=tuple(SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true", help="2x16x16 mesh only")
    ap.add_argument("--single-pod", action="store_true", help="16x16 mesh only")
    ap.add_argument("--transport", default="xla")
    ap.add_argument("--moe-dispatch", default=None)
    ap.add_argument("--attn-chunk", type=int, default=None)
    ap.add_argument("--remat", default=None)
    ap.add_argument("--kv-partition", default="auto")
    ap.add_argument("--out", default="results/dryrun")
    ap.add_argument("--tag", default="")
    args = ap.parse_args(argv)

    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)

    archs = [args.arch] if args.arch else list(ARCH_IDS)
    shapes = [args.shape] if args.shape else list(SHAPES)
    pods = [False, True]
    if args.multi_pod:
        pods = [True]
    if args.single_pod:
        pods = [False]

    n_fail = 0
    for arch in archs:
        for shape in shapes:
            for mp in pods:
                t0 = time.time()
                try:
                    rec = lower_cell(arch, shape, multi_pod=mp,
                                     transport=args.transport,
                                     moe_dispatch=args.moe_dispatch,
                                     attn_chunk=args.attn_chunk,
                                     remat=args.remat,
                                     kv_partition=args.kv_partition)
                except Exception as e:  # a failure here is a bug in the system
                    n_fail += 1
                    rec = {"arch": arch, "shape": shape, "multi_pod": mp,
                           "skipped": False, "error": f"{type(e).__name__}: {e}",
                           "traceback": traceback.format_exc()[-2000:]}
                    print(f"FAIL {arch} {shape} mp={mp}: {e}")
                tag = f"__{args.tag}" if args.tag else ""
                (out / (cell_id(rec) + tag + ".json")).write_text(json.dumps(rec, indent=1))
                status = ("SKIP" if rec.get("skipped") else
                          ("ERR " if "error" in rec else "OK  "))
                head = f"{status} {arch:24s} {shape:12s} {'2pod' if mp else '1pod'} " \
                       f"({time.time() - t0:5.1f}s)"
                if "roofline" in rec:
                    r = rec["roofline"]
                    print(f"{head} dom={r['dominant']} comp={r['compute_s']:.3e}s "
                          f"mem={r['memory_s']:.3e}s coll={r['collective_s']:.3e}s "
                          f"fits={rec['memory']['fits_16GB']}")
                    print(f"     memory: {rec['memory']}")
                    print(f"     cost_analysis: {rec['cost_analysis']}")
                else:
                    print(f"{head} {rec.get('reason', rec.get('error', ''))[:90]}")
    if n_fail:
        raise SystemExit(f"{n_fail} cells failed")


if __name__ == "__main__":
    main()
