"""The training step with the Bertha seam.

The counterpart of ``src/repro/train/step.py``. The gradient path is:

    loss.backward()  ->  [grad chunnel stack]  ->  AdamW

on every rank of the mesh, each with its slice of the global batch: the rows
the reference's ``data_spec`` gives it, the flattened (``pod``, ``data``)
index (all of them when the batch does not divide).

The reference's partitioner averages the gradient over every batch axis
that the stack leaves automatic; the port has none, so the step does it
itself: one all-reduce mean of the flattened gradient over each such axis
of more than one rank. With the ``xla`` transport (no chunnel) that is the
whole sync. Any other transport takes its ``manual_axes`` and averages over
them itself, on the gradient tree in the reference's layout
(``stacking.stack_layers``: layer leaves stacked, reference leaf order), so
the flat vector it flattens, and every block its int8 wire quantizes, is the
reference's. Loss and metrics are averaged over the batch axes.

Reconfiguring the transport builds the step again with another stack: state
(params, optimizer, chunnel state) carries over. All state is replicated:
every rank holds every parameter (sharding waits for its slice).
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Sequence

import numpy as np
import torch

from repro_torch import tree as T
from repro_torch.comm import collectives
from repro_torch.comm.chunnels import (
    StepChunnel,
    apply_grad_stack,
    init_grad_states,
    stack_manual_axes,
)
from repro_torch.configs.base import TrainConfig
from repro_torch.launch.mesh import BATCH_AXES
from repro_torch.models import registry
from repro_torch.models.stacking import stack_layers, unstack_layers
from repro_torch.optim import adamw


class TrainState(NamedTuple):
    params: dict  # name -> the model's parameter (updated in place)
    opt: adamw.AdamWState
    comm: Any  # chunnel states (EF residuals, localsgd counters, ...)
    step: int


def _opt_dtype(tcfg: TrainConfig) -> torch.dtype:
    return getattr(torch, tcfg.opt_dtype)


def init_state(model, tcfg: TrainConfig = TrainConfig()) -> TrainState:
    """The state of ``model`` as its parameters stand, moments at zero."""
    params = dict(model.named_parameters())
    return TrainState(params=params, opt=adamw.init(params, _opt_dtype(tcfg)),
                      comm=(), step=0)


def grad_shapes(model) -> dict:
    """The gradient tree's shapes in the reference's layout, as meta
    tensors (what ``init_grad_states`` reads)."""
    return stack_layers({n: p.detach() for n, p in model.named_parameters()},
                        model.cfg.num_layers,
                        stack=lambda ts: torch.empty((len(ts),) + tuple(ts[0].shape),
                                                     device="meta"))


def state_shapes(model, grad_chunnels: Sequence[StepChunnel],
                 tcfg: TrainConfig = TrainConfig()) -> TrainState:
    """A state of ``model``'s structure, its leaves on the model's device
    (what ``Checkpointer.restore`` fills)."""
    params = dict(model.named_parameters())
    comm = init_grad_states(grad_chunnels, grad_shapes(model))
    return TrainState(params=params, opt=adamw.init(params, _opt_dtype(tcfg)), comm=comm,
                      step=0)


def local_rows(batch: dict, mesh) -> dict:
    """This rank's rows of each array of the global ``batch``."""
    idx, n = mesh.batch_index()
    out = {}
    for k, v in batch.items():
        rows = v.shape[0]
        if n > 1 and rows % n == 0 and rows > 0:
            per = rows // n
            v = v[idx * per:(idx + 1) * per]
        out[k] = torch.as_tensor(np.ascontiguousarray(v)).to(mesh.device)
    return out


def _mean_over(values: torch.Tensor, mesh, axes) -> torch.Tensor:
    for a in axes:
        values = collectives.all_reduce_sum(values, mesh, a) / mesh.shape[a]
    return values


def make_train_step(model, tcfg: TrainConfig, grad_chunnels: Sequence[StepChunnel],
                    mesh) -> Callable:
    """Returns step(state, batch) -> (state, metrics); ``batch`` is the
    global batch as numpy arrays."""
    lr_fn = adamw.lr_schedule(tcfg)
    manual = stack_manual_axes(grad_chunnels) & set(mesh.axis_names)
    batch_axes = [a for a in BATCH_AXES if a in mesh.axis_names and mesh.shape[a] > 1]
    auto = [a for a in batch_axes if a not in manual]
    ctx = {"mesh": mesh}
    L = model.cfg.num_layers
    n_mb = max(tcfg.microbatches, 1)

    def grads_of(batch) -> torch.Tensor:
        """Backward of the local batch's mean loss into the parameters'
        ``.grad``, over ``n_mb`` microbatches; returns the loss."""
        rows = batch["tokens"].shape[0]
        if rows % n_mb:
            raise ValueError(f"{rows} local rows do not split into {n_mb} microbatches")
        per = rows // n_mb
        total = torch.zeros((), dtype=torch.float32, device=mesh.device)
        for i in range(n_mb):
            mb = {k: v[i * per:(i + 1) * per] for k, v in batch.items()}
            loss = registry.loss(model, mb)
            (loss / n_mb).backward()
            total = total + loss.detach() / n_mb
        return total

    def step_fn(state: TrainState, batch) -> tuple:
        local = local_rows(batch, mesh)
        for p in state.params.values():
            p.grad = None
        loss = grads_of(local)
        grads = {n: p.grad for n, p in state.params.items()}
        if auto:  # what the reference's partitioner averages
            for a in auto:
                grads = collectives.pmean_tree(grads, mesh, a)
        comm = state.comm
        if grad_chunnels:
            tree, comm = apply_grad_stack(grad_chunnels, stack_layers(grads, L), comm, ctx)
            grads = unstack_layers(tree, L)
        params, opt, metrics = adamw.update(grads, state.opt, state.params,
                                            lr_fn(state.step), tcfg)
        for p in state.params.values():
            p.grad = None
        values = _mean_over(torch.stack([loss, metrics["grad_norm"].to(loss.device)]),
                            mesh, batch_axes).tolist()
        return (TrainState(params, opt, comm, state.step + 1),
                {"loss": values[0], "grad_norm": values[1]})

    return step_fn
