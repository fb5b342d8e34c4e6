"""A mesh of named axes over the ranks of a ``torch.distributed`` world.

The counterpart of ``src/repro/launch/mesh.py``. The reference's mesh is one
program's view of many devices; here every rank is a process of its own and
holds a :class:`Mesh` with the reference's face: ``axis_names``, a ``shape``
dict, and for each axis of more than one rank a process group of the ranks
that differ only along it. Code that reads ``mesh.shape[...]`` and
``mesh.axis_names`` (the cost calibration, the trainer) carries over.

Ranks are laid out row-major over the axes, the first outermost: with axes
(``pod``, ``data``) rank ``p * |data| + d`` sits at pod ``p``, data ``d``,
which is also the order in which the reference's ``data_spec`` deals the
batch's rows out over the flattened (``pod``, ``data``) index.

The backend is the caller's choice and is never changed behind its back:
``nccl`` when each rank has a GPU of its own, ``gloo`` for CPU tensors and
for ranks that share one GPU (NCCL refuses two ranks on one device).
:func:`choose_backend` states that rule; :func:`init_distributed` prints the
backend it starts. :func:`spawn` runs a function on every rank of a new
world, each in a process of its own.

Any axis may hold more than one rank. The batch is dealt out over ``pod``
and ``data`` only (``batch_index``): the ranks along ``model`` see the same
rows, and a model's parameters are split over ``data`` and ``model`` by
``models.sharding`` (``train.step.shardings_for``).
"""
from __future__ import annotations

import importlib
import itertools
import math
import os
import queue
import shutil
import tempfile
import time
import traceback
from datetime import timedelta
from typing import Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

from repro_torch.backend import resolve_device

#: the axes the batch's rows are dealt out over
BATCH_AXES = ("pod", "data")


class Mesh:
    """Named axes over a world of ranks, with one process group per axis."""

    def __init__(self, shape: Dict[str, int], *, device, backend: Optional[str] = None):
        self.shape = dict(shape)
        self.axis_names = tuple(self.shape)
        self.size = math.prod(self.shape.values())
        self.device = resolve_device(device)
        if self.size == 1:
            self.rank, self.backend = 0, backend
        else:
            if not dist.is_initialized():
                raise RuntimeError(f"a mesh of {self.size} ranks needs torch.distributed "
                                   "initialised first (init_distributed)")
            if dist.get_world_size() != self.size:
                raise ValueError(f"mesh {self.shape} has {self.size} ranks, the world "
                                 f"{dist.get_world_size()}")
            self.rank = dist.get_rank()
            self.backend = dist.get_backend()
            if backend is not None and backend != self.backend:
                raise ValueError(f"the world runs {self.backend}, not {backend}")
        strides, s = {}, 1
        for a in reversed(self.axis_names):
            strides[a] = s
            s *= self.shape[a]
        self._strides = strides
        self.coords = {a: (self.rank // strides[a]) % self.shape[a] for a in self.axis_names}
        self._members: Dict[str, List[int]] = {}
        self._groups: Dict[str, Optional[dist.ProcessGroup]] = {}
        for a in self.axis_names:
            self._members[a], self._groups[a] = self._make_group(a)

    def _make_group(self, axis: str):
        """The ranks along ``axis`` through this rank, and their group. Every
        rank makes every group of the axis, in one order, as ``new_group``
        requires."""
        n = self.shape[axis]
        base = self.rank - self.coords[axis] * self._strides[axis]
        mine = [base + i * self._strides[axis] for i in range(n)]
        if n == 1:
            return mine, None
        if n == self.size:
            return mine, dist.group.WORLD
        others = [a for a in self.axis_names if a != axis]
        group = None
        for combo in itertools.product(*(range(self.shape[a]) for a in others)):
            b = sum(c * self._strides[a] for a, c in zip(others, combo))
            ranks = [b + i * self._strides[axis] for i in range(n)]
            g = dist.new_group(ranks)
            if ranks == mine:
                group = g
        return mine, group

    def group(self, axis: str) -> Optional[dist.ProcessGroup]:
        """The process group along ``axis``; None when it has one rank."""
        return self._groups[axis]

    def members(self, axis: str) -> List[int]:
        """Global ranks along ``axis`` through this rank, by axis index."""
        return self._members[axis]

    def batch_index(self) -> tuple:
        """(row block, blocks): this rank's place in the flattened
        (``pod``, ``data``) index and the number of places."""
        axes = [a for a in BATCH_AXES if a in self.shape]
        idx, n = 0, 1
        for a in axes:
            idx = idx * self.shape[a] + self.coords[a]
            n *= self.shape[a]
        return idx, n

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, rank {self.rank}, backend {self.backend}, "
                f"device {self.device})")


class AbstractMesh:
    """A mesh's shape without its ranks: the axes, their sizes and one
    rank's coordinates (rank 0's by default), no process group and no
    device. What the layout reads (``models.sharding``'s specs and
    ``local_slice``) works on it, so the dry run (``launch.dryrun``) prices
    the production meshes from one process."""

    def __init__(self, shape: Dict[str, int], rank: int = 0):
        self.shape = dict(shape)
        self.axis_names = tuple(self.shape)
        self.size = math.prod(self.shape.values())
        self.rank = rank
        strides, s = {}, 1
        for a in reversed(self.axis_names):
            strides[a] = s
            s *= self.shape[a]
        self.coords = {a: (rank // strides[a]) % self.shape[a] for a in self.axis_names}

    def group(self, axis: str):
        raise RuntimeError("an abstract mesh has no process groups")

    batch_index = Mesh.batch_index

    def __repr__(self) -> str:
        return f"AbstractMesh({self.shape}, rank {self.rank})"


def make_mesh(shape: Sequence[int], axes: Sequence[str], *, device="cuda",
              backend: Optional[str] = None) -> Mesh:
    if len(shape) != len(axes):
        raise ValueError(f"shape {tuple(shape)} for axes {tuple(axes)}")
    return Mesh(dict(zip(axes, shape)), device=device, backend=backend)


def make_test_mesh(shape=(1, 1), axes=("data", "model"), *, device="cuda") -> Mesh:
    """The reference's ``make_test_mesh`` over this world's ranks; its own
    training mesh is ``make_test_mesh((2, 4))``, 8 ranks with 4 on ``model``."""
    return make_mesh(shape, axes, device=device)


def production_shape(multi_pod: bool = False) -> Dict[str, int]:
    """The reference's production mesh, (data 16, model 16), or (pod 2,
    data 16, model 16) with ``multi_pod``."""
    return {"pod": 2, "data": 16, "model": 16} if multi_pod else {"data": 16, "model": 16}


def make_production_mesh(*, multi_pod: bool = False, device="cuda") -> Mesh:
    """The production mesh over a world of 256 or 512 ranks."""
    shape = production_shape(multi_pod)
    return make_mesh(tuple(shape.values()), tuple(shape), device=device)


#: One NVIDIA H100 SXM5 80GB, as the roofline prices it (``analysis.roofline``
#: and ``chip_smoke.py``'s bounds), from NVIDIA's H100 Tensor Core GPU data
#: sheet: the dense (no sparsity) tensor-core and FP32 rates, HBM3, NVLink 4
#: (18 links, 900 GB/s per GPU, the data sheet's total of both directions) in
#: an HGX H100 node of 8 GPUs, and one NDR InfiniBand NIC per GPU (400 Gb/s)
#: between nodes. The reference's table prices a TPU v5e.
HW = {
    "peak_flops_bf16": 989e12,  # FLOP/s
    "peak_flops_f32": 67e12,  # FLOP/s outside the tensor cores
    "hbm_bw": 3.35e12,  # B/s
    "hbm_bytes": 80e9,  # B
    "nvlink_bw": 900e9,  # B/s per GPU, inside a node
    "ib_bw": 50e9,  # B/s per GPU, between nodes
    "node_gpus": 8,  # GPUs on one NVLink domain
}


def choose_backend(device, world: int) -> str:
    """``gloo`` for CPU tensors and for ranks that share one GPU, ``nccl``
    when every rank has a GPU of its own."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return "gloo"
    return "nccl" if torch.cuda.device_count() >= world else "gloo"


def rank_device(device, rank: int, backend: str) -> torch.device:
    """The device of ``rank``: its own GPU under ``nccl``, the one GPU the
    ranks share under ``gloo``, or the CPU."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev
    if backend == "nccl":
        return torch.device("cuda", rank)
    return dev if dev.index is not None else torch.device("cuda", 0)


def init_distributed(rank: int, world: int, *, backend: str, init_method: str,
                     timeout_s: float = 600.0, reason: str = "") -> None:
    """Start this process's rank of the world and say which backend runs it."""
    if backend not in ("gloo", "nccl"):
        raise ValueError(f"backend {backend!r}: use 'gloo' or 'nccl'")
    dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world,
                            timeout=timedelta(seconds=timeout_s))
    if rank == 0:
        print(f"torch.distributed: backend {backend}, world {world}"
              + (f" ({reason})" if reason else ""), flush=True)


def _rank_main(rank, world, backend, init_method, target, args, results, timeout_s, reason,
               threads):
    torch.set_num_threads(threads)
    try:
        init_distributed(rank, world, backend=backend, init_method=init_method,
                         timeout_s=timeout_s, reason=reason)
        module, name = target.split(":")
        out = getattr(importlib.import_module(module), name)(*args)
        results.put(("ok", rank, out))
    except BaseException:  # reported to the parent, which fails the run
        results.put(("error", rank, traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(target: str, world: int, *, backend: str, args: tuple = (),
          threads: Optional[int] = None, timeout_s: float = 900.0, reason: str = "") -> list:
    """Run ``module:function`` with ``args`` on each rank of a new world of
    ``world`` processes (``spawn`` start method, file rendezvous under
    ``TMPDIR``) and return each rank's result, by rank. Results must pickle
    (numbers, numpy arrays). Any rank's exception, a nonzero exit code or
    the timeout fails the whole run, and no process outlives it.

    Each rank runs torch's CPU ops on ``threads`` threads, by default the
    host's cores shared out over the world. A caller that shares the host
    with other work (a test beside other test workers) passes fewer: ranks
    that spin on more threads than they get cores delay every other
    process's wakeups."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="repro_torch_rdv_")
    init_method = f"file://{os.path.join(tmp, 'rendezvous')}"
    results = ctx.Queue()
    if threads is None:
        threads = max(1, (os.cpu_count() or 1) // world)
    procs = [ctx.Process(target=_rank_main, name=f"rank{r}",
                         args=(r, world, backend, init_method, target, args, results,
                               timeout_s, reason, threads))
             for r in range(world)]
    out: Dict[int, object] = {}
    errors: List[str] = []
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s
        while len(out) + len(errors) < world:
            try:
                kind, rank, val = results.get(timeout=1.0)
            except queue.Empty:
                dead = [p for p in procs if p.exitcode not in (None, 0)]
                if dead and not errors:
                    errors.append(f"{dead[0].name} exited with code {dead[0].exitcode} "
                                  "before reporting")
                if errors or time.monotonic() > deadline:
                    break
                continue
            if kind == "ok":
                out[rank] = val
            else:
                errors.append(f"rank {rank}:\n{val}")
                deadline = min(deadline, time.monotonic() + 10.0)  # let peers fail too
        for p in procs:
            p.join(timeout=30.0)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=10.0)
        shutil.rmtree(tmp, ignore_errors=True)
    if errors:
        raise RuntimeError("spawned ranks failed:\n" + "\n".join(errors))
    if len(out) < world:
        raise TimeoutError(f"{world - len(out)} of {world} ranks did not finish in "
                           f"{timeout_s} s")
    bad = [f"{p.name}: exit code {p.exitcode}" for p in procs if p.exitcode != 0]
    if bad:
        raise RuntimeError("spawned ranks exited badly: " + ", ".join(bad))
    return [out[r] for r in range(world)]


__all__ = ["BATCH_AXES", "HW", "AbstractMesh", "Mesh", "choose_backend", "init_distributed",
           "make_mesh", "make_production_mesh", "make_test_mesh", "production_shape",
           "rank_device", "spawn"]
