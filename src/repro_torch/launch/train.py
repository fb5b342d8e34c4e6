"""Training launcher: negotiate the gradient transport, train, checkpoint.

  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \\
      --steps 8 --batch 8 --seq 128 --transport xla --ckpt /tmp/ckpt --ckpt-every 4
  PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu \\
      --world 2 --backend gloo --transport compressed_int8 --steps 4
  PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu \\
      --world 4 --model 2 --backend gloo --transport psum --steps 3
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-moe-235b-a22b \\
      --layers 1 --steps 4 --batch 8 --seq 128 --transport xla

The counterpart of ``src/repro/launch/train.py``, for every arch of the zoo
(``--arch``), with the reference's flags. Its ``--mesh`` (a JAX device mesh)
becomes ``--world`` ranks, each a process this launcher spawns, laid out as
(``pod`` = world / (``--data`` x ``--model``), ``data``, ``model``) over a
``torch.distributed`` world of
``--backend`` (by default ``gloo`` on the CPU or when the ranks outnumber the
GPUs, which then share one, else ``nccl``; the choice is printed). One rank
(the default) runs in this process on a mesh with no ``pod`` axis, so no
transport chunnel is built, as in the reference's ``--mesh none``. The state
is laid out by the reference's sharding rules (FSDP over ``data`` unless
``--no-fsdp``, tensor parallelism over ``model``, ZeRO-1 moments over
``pod``); rank 0 prints the layout on start, and after the run the bytes it
sent a step by ``op@axis`` (the compute split's gathers and reduce-scatters
over S, the vocabulary split's sums). It trains on ``--device`` (``cuda`` by
default, which raises without a GPU) from
parameters drawn from seed 0; ``--layers N`` keeps the first N layers of the
published config (a cut of depth). ``main(argv)`` returns the run's losses and
step times (rank 0's).
"""
from __future__ import annotations

import argparse
import dataclasses
import math
import statistics
import sys
import time
from dataclasses import dataclass, field
from typing import List, Optional

import torch

from repro_torch.comm import collectives
from repro_torch.configs import get_config, get_smoke_config
from repro_torch import tree as T
from repro_torch.configs.base import ShapeConfig, ShardingConfig, TrainConfig
from repro_torch.data.synthetic import batches_for
from repro_torch.launch.mesh import choose_backend, make_mesh, rank_device, spawn
from repro_torch.launch.serve import cut_depth
from repro_torch.train.trainer import HostSpec, ReconfigurableTrainer

#: the parameters' seed (the reference trains its init from PRNGKey(0))
SEED = 0


@dataclass
class TrainRun:
    arch: str
    transport: str
    world: int
    backend: Optional[str]
    tokens_per_step: int  # global batch x sequence
    losses: List[float]
    step_s: List[float]
    reconfig_log: List[dict] = field(default_factory=list)
    peak_memory_bytes: Optional[int] = None  # on the GPU; None on the CPU
    n_params: Optional[int] = None  # the model's, whole
    #: the bytes the rank sent a step by ``op@axis`` (``collectives.SENT``),
    #: the run's mean
    sent_per_step: dict = field(default_factory=dict)

    @property
    def first_ms(self) -> float:
        return self.step_s[0] * 1e3

    @property
    def warm_ms(self) -> float:
        """Median ms of the steps after the first."""
        return statistics.median(self.step_s[1:] or self.step_s) * 1e3

    @property
    def tokens_per_s(self) -> float:
        return self.tokens_per_step / (self.warm_ms / 1e3)


def parse(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--layers", type=int, default=None,
                    help="train only the first N layers (a cut of depth)")
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--transport", default="xla")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--world", type=int, default=1, help="ranks, one process each")
    ap.add_argument("--data", type=int, default=1, help="ranks on the data axis")
    ap.add_argument("--model", type=int, default=1, help="ranks on the model axis")
    ap.add_argument("--no-fsdp", action="store_true",
                    help="replicate parameters over data (no ZeRO-3)")
    ap.add_argument("--backend", default=None, choices=("gloo", "nccl"))
    ap.add_argument("--threads", type=int, default=None,
                    help="CPU threads of each spawned rank (default: the cores over the world)")
    args = ap.parse_args(argv)
    if args.world < 1 or args.world % (args.data * args.model):
        raise ValueError(f"--data {args.data} x --model {args.model} does not divide "
                         f"--world {args.world}")
    return args


def mesh_shape(args: argparse.Namespace) -> tuple:
    """(shape, axes) of the launcher's mesh."""
    if args.world == 1:
        return (1,), ("data",)
    return ((args.world // (args.data * args.model), args.data, args.model),
            ("pod", "data", "model"))


def build(args: argparse.Namespace, mesh) -> ReconfigurableTrainer:
    """The trainer the launcher runs, on ``mesh``."""
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if args.layers is not None:
        cfg = cut_depth(cfg, args.layers)
    shape = ShapeConfig("cli", args.seq, args.batch, "train")
    hosts = [HostSpec(h, [args.transport, "xla"]) for h in range(mesh.size)]
    return ReconfigurableTrainer(
        cfg, shape, mesh, tcfg=TrainConfig(warmup_steps=10, total_steps=args.steps),
        sharding=ShardingConfig(fsdp=not args.no_fsdp), transport=args.transport,
        ckpt_dir=args.ckpt, hosts=hosts)


def layout_line(tr: ReconfigurableTrainer, state) -> str:
    """The state's layout on this rank: mesh, parameter and moment bytes
    held against the whole."""
    held = sum(p.numel() * p.element_size() for p in state.params.values())
    whole = sum(4 * math.prod(s) for s in tr.state_sh.shapes.values())
    mom = sum(t.numel() * t.element_size() for t in T.leaves((state.opt.m, state.opt.v)))
    split = sum(1 for n in tr.state_sh.params if tr.state_sh.params[n].splits(
        len(tr.state_sh.shapes[n])))
    axes = " x ".join(f"{a} {n}" for a, n in tr.mesh.shape.items())
    return (f"layout: {axes}, fsdp {'on' if tr.sharding.fsdp else 'off'}; {split} of "
            f"{len(tr.state_sh.params)} parameters split; rank {tr.mesh.rank} holds {held} of "
            f"{whole} parameter bytes and {mom} moment bytes")


def train(args: argparse.Namespace, mesh) -> TrainRun:
    """Build the trainer on ``mesh``, draw (or restore) the state, run."""
    tr = build(args, mesh)
    gen = batches_for(tr.cfg, tr.shape)
    state = tr.init_state(SEED)
    if mesh.rank == 0:
        print(layout_line(tr, state), flush=True)
    if args.resume and args.ckpt:
        state, at = tr.restore()
        if mesh.rank == 0:
            print(f"resumed from step {at}")
    dev = mesh.device
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    sent0 = dict(collectives.SENT)
    state, hist = tr.run(state, gen, args.steps, ckpt_every=args.ckpt_every)
    sent = {k: (v - sent0.get(k, 0)) / max(len(hist), 1) for k, v in collectives.SENT.items()
            if v - sent0.get(k, 0)}
    losses = [h["loss"] for h in hist]
    if not all(math.isfinite(l) for l in losses):
        raise RuntimeError(f"non-finite loss: {losses}")
    return TrainRun(tr.cfg.name, tr.transport_name, mesh.size, mesh.backend,
                    tr.shape.tokens, losses, tr.step_times[-len(hist):],
                    list(tr.reconfig_log),
                    torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None,
                    sum(math.prod(s) for s in tr.state_sh.shapes.values()), sent)


def _rank(argv: List[str], backend: str) -> dict:
    """One rank of a spawned run: its mesh over the world, then ``train``."""
    import torch.distributed as dist

    args = parse(argv)
    rank = dist.get_rank()
    dev = rank_device(args.device, rank, backend)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    mesh = make_mesh(*mesh_shape(args), device=dev)
    return dataclasses.asdict(train(args, mesh))


def main(argv: Optional[List[str]] = None) -> TrainRun:
    argv = sys.argv[1:] if argv is None else list(argv)
    args = parse(argv)
    t0 = time.time()
    if args.world == 1:
        run = train(args, make_mesh(*mesh_shape(args), device=args.device))
    else:
        backend = args.backend or choose_backend(args.device, args.world)
        why = ("CPU tensors" if torch.device(args.device).type == "cpu"
               else "a GPU per rank" if backend == "nccl"
               else "the ranks share one GPU; NCCL refuses two ranks on one device")
        runs = spawn("repro_torch.launch.train:_rank", args.world, backend=backend,
                     args=(argv, backend), threads=args.threads, reason=why)
        if any(r["losses"] != runs[0]["losses"] for r in runs):
            raise RuntimeError(f"ranks report different losses: {[r['losses'] for r in runs]}")
        run = TrainRun(**runs[0])
    dt = time.time() - t0
    print(f"arch={run.arch} transport={run.transport} world={run.world} "
          f"backend={run.backend} steps={len(run.losses)} "
          f"loss {run.losses[0]:.3f} -> {run.losses[-1]:.3f} "
          f"({run.warm_ms:.0f} ms/step warm, {dt:.1f} s in all)")
    if run.sent_per_step:
        print(f"rank 0 sent a step by op@axis: {run.sent_per_step}")
    if run.reconfig_log:
        print("reconfigurations:", run.reconfig_log)
    return run


if __name__ == "__main__":
    main()
