"""End-to-end run of the PyTorch port: train a small LM on a mesh with a
``model`` axis, with a live transport reconfiguration and a kill + restore.

    PYTHONPATH=src python examples/torch_train_reconfigure.py --device cpu [--steps 200]

The counterpart of ``examples/train_reconfigure.py``, on (pod 2, model 4):
eight ranks, each a process (``gloo``; on a GPU they share it), the
parameters split over ``model`` (tensor parallelism) and replicated over
``pod``. It shows the paper's pitch on the training plane:

  * negotiation picks the transport all hosts support (``psum``);
  * a straggler (an injected slowdown) triggers a negotiated 2PC transition
    to the DCN-lighter ``compressed_int8`` transport without losing state;
  * a kill + restore: a new trainer, built as a restarted job would be,
    restores the atomic checkpoint onto the mesh and trains on with the
    losses of the run that was not killed, within 1e-3 (relative): the
    checkpoint holds every leaf once, so each pod's error-feedback residual
    comes back as pod 0's, as the reference's does (a few 1e-5 apart over
    10 steps on the CPU).

It runs on ``--device`` (``cuda`` by default, which raises without a GPU).
``main(argv)`` returns rank 0's record.
"""
from __future__ import annotations

import argparse
import math
import sys
import tempfile
from typing import List, Optional

import torch

from repro_torch.backend import resolve_device
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import ShapeConfig, TrainConfig
from repro_torch.data.synthetic import batches_for
from repro_torch.launch.mesh import choose_backend, make_mesh, rank_device, spawn
from repro_torch.train.trainer import HostSpec, ReconfigurableTrainer, StragglerPolicy

OFFERS = ["psum", "compressed_int8"]


def parse(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--pod", type=int, default=2, help="ranks on the pod axis")
    ap.add_argument("--model", type=int, default=4, help="ranks on the model axis")
    ap.add_argument("--window", type=int, default=8, help="the straggler policy's window")
    ap.add_argument("--slow", type=float, default=0.05,
                    help="seconds added to each step once the straggler appears")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def _trainer(args, mesh, ckpt_dir: str, offers: List[str]) -> ReconfigurableTrainer:
    cfg = get_smoke_config("llama3.2-1b")
    return ReconfigurableTrainer(
        cfg, ShapeConfig("e2e", 128, 8, "train"), mesh,
        tcfg=TrainConfig(learning_rate=1e-3, warmup_steps=10, total_steps=args.steps),
        transport=offers[0], ckpt_dir=ckpt_dir,
        hosts=[HostSpec(h, list(offers)) for h in range(args.pod)])


def _rank(argv: List[str], ckpt_dir: str, backend: str) -> dict:
    """One rank of the run (spawn target)."""
    import torch.distributed as dist

    args = parse(argv)
    dev = rank_device(args.device, dist.get_rank(), backend)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    mesh = make_mesh((args.pod, args.model), ("pod", "model"), device=dev)
    trainer = _trainer(args, mesh, ckpt_dir, OFFERS)
    negotiated = trainer.transport_name
    state = trainer.init_state(0)
    gen = batches_for(trainer.cfg, trainer.shape)

    half = args.steps // 2
    # phase 1: normal training; a straggler appears after 1/4 of the steps
    state, hist1 = trainer.run(
        state, gen, half, ckpt_every=max(half // 2, 1),
        straggler=StragglerPolicy(window=args.window, slow_factor=1.4,
                                  fallback="compressed_int8"),
        inject_slow=lambda i: args.slow if i > half // 2 else 0.0)
    trainer.save(state)
    at_kill = int(state.step)

    # phase 2 as it runs on, and after a kill: a new trainer (the job
    # restarted on its last committed transport) restores the checkpoint
    state, hist2 = trainer.run(state, gen, args.steps - half)
    restarted = _trainer(args, mesh, ckpt_dir, [trainer.transport_name])
    restored, at = restarted.restore(step=at_kill)
    restored, hist3 = restarted.run(restored, gen, args.steps - half)
    return {"negotiated": negotiated, "reconfig_log": trainer.reconfig_log,
            "transport": trainer.transport_name, "restored_at": at,
            "phase1": [h["loss"] for h in hist1], "phase2": [h["loss"] for h in hist2],
            "after_restore": [h["loss"] for h in hist3]}


def main(argv: Optional[List[str]] = None) -> dict:
    argv = sys.argv[1:] if argv is None else list(argv)
    args = parse(argv)
    resolve_device(args.device)  # no GPU: raise here, before any rank starts
    world = args.pod * args.model
    backend = choose_backend(args.device, world)
    with tempfile.TemporaryDirectory(prefix="repro-torch-ckpt-") as ckpt_dir:
        runs = spawn("torch_train_reconfigure:_rank", world, backend=backend,
                     args=(argv, ckpt_dir, backend), reason="one process per rank")
    run = runs[0]
    if any(r != run for r in runs):
        raise RuntimeError("the ranks report different runs")
    print(f"mesh pod {args.pod} x model {args.model}, {world} ranks ({backend})")
    print(f"negotiated transport: {run['negotiated']}")
    p1, p2, p3 = run["phase1"], run["phase2"], run["after_restore"]
    print(f"phase1 loss {p1[0]:.3f} -> {p1[-1]:.3f}; reconfigurations: {run['reconfig_log']}")
    print(f"restored at step {run['restored_at']}")
    print(f"phase2 loss {p2[0]:.3f} -> {p2[-1]:.3f} (transport now: {run['transport']}); "
          f"after the restore {p3[0]:.3f} -> {p3[-1]:.3f}")
    assert all(math.isfinite(l) for l in p1 + p2 + p3)
    drift = max(abs(a - b) / abs(b) for a, b in zip(p3, p2))
    print(f"restored run against the run that was not killed: max relative difference {drift}")
    assert drift <= 1e-3, "the restored run's losses differ from the run that was not killed"
    assert p2[-1] < p1[0], "loss should improve across restart"
    print("torch_train_reconfigure OK")
    return run


if __name__ == "__main__":
    main()
