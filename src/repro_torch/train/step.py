"""The training step with the Bertha seam, and the state's layout on a mesh.

The counterpart of ``src/repro/train/step.py``. The gradient path is:

    loss.backward()  ->  [grad chunnel stack]  ->  AdamW

on every rank of the mesh, each with its slice of the global batch: the rows
the reference's ``data_spec`` gives it, the flattened (``pod``, ``data``)
index (all of them when the batch does not divide). The ranks along
``model`` share their rows.

Layout (``shardings_for``, the reference's l.170-218). Each rank holds the
block of every parameter, moment and chunnel-state leaf that the reference's
``NamedSharding`` gives the device at its mesh coordinates: parameters by
``models.sharding.param_spec`` (FSDP over ``data``, tensor parallelism over
``model``), moments by ``_zero1_pod`` (their ``data`` dim further over
``pod``), error-feedback residuals by the parameters' specs. The model
gathers each layer's parameters for its forward (``sharding.Layout``); the
backward leaves each rank its block of the gradient, summed over ``data``
where the parameter is split on it. Under the compute split over ``model``
(``models.pshard``: every family, xLSTM's mLSTM by heads and sLSTM by
channels) a leaf the split consumes is gathered over the batch axes only
and yields its block's gradient directly; a leaf it reads as a shared part
yields its block of the gradient's sum over ``model`` (its gather's
reduce-scatter), or, where the layout replicates it (the sLSTM's ``r``,
read as its columns of the rank's channels), the whole sum (its read's
``replicated``). Each gradient is summed over ``model`` once, by the read or
the collective that takes its input (the moe router under a mesh dispatch
by ``moe._router`` alone, never also as a shared read; a whole block's
input, the xLSTM norms' too, by the "f" after it); the step then only
averages equal values over ``model`` (:func:`_agree_over`).

The reference's partitioner averages the gradient over every batch axis that
the stack leaves automatic; the port has none, so the step does it itself:
a leaf split over the axis was summed by its gather's backward and is
divided by the axis size, any other leaf is all-reduced to the mean. With
the ``xla`` transport (no chunnel) that is the whole sync. Any other
transport takes its ``manual_axes`` and averages over them itself, as the
reference's does inside its ``shard_map``: on the rank's own shard of the
gradient. The stack runs on the tree in the reference's layout
(``stacking.stack_layers``: layer leaves stacked, reference leaf order) of
the rank's blocks, with ``ctx["shards"]`` (``train.gradshard.GradShards``):
a float32 transport reduces the blocks as they are (it is elementwise); an
int8 one adds its residuals to them first, then gathers over ``data`` and
``model`` (``gather_grad``) only the leaves whose blocks are not whole
blocks of its wire (none at the published widths), so that every block it
quantizes, and every leaf block its error feedback quantizes, is the
reference's; each rank keeps its block of the result and of the chunnel
state, laid out as the reference's ``shardings_for`` lays it out. A
transport that takes an axis manual (the hierarchical ones take ``data``)
sees the parameters replicated over it, as the reference's ``shard_map``
replicates them inside: its layout drops that axis from the specs. Loss and
metrics are averaged over the batch axes.

Reconfiguring the transport builds the step again with another stack, and
the trainer lays the state out again by its shardings: state (params,
optimizer, chunnel state) carries over.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional, Sequence

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
from repro_torch.configs.base import ShardingConfig, TrainConfig
from repro_torch.launch.mesh import BATCH_AXES
from repro_torch.models import registry
from repro_torch.models.sharding import P, Layout, NamedSharding, per_layer
from repro_torch.models.stacking import stack_layers, unstack_layers
from repro_torch.obs.ranges import span
from repro_torch.optim import adamw
from repro_torch.train.gradshard import GradShards


class TrainState(NamedTuple):
    params: dict  # name -> the model's parameter (updated in place)
    opt: adamw.AdamWState
    comm: Any  # chunnel states (EF residuals, localsgd counters, ...)
    step: int


def _opt_dtype(tcfg: TrainConfig) -> torch.dtype:
    return getattr(torch, tcfg.opt_dtype)


def adam_shards(state_sh: TrainState):
    """``adamw.LeafShard`` of each parameter, from the state's shardings
    (None when the state is not laid out on a mesh)."""
    if state_sh is None:
        return None

    def leaf(p_sh: NamedSharding, m_sh: NamedSharding, shape) -> adamw.LeafShard:
        zero1 = next((d for d, a in m_sh.splits(len(shape))
                      if a == "pod" and (d, a) not in p_sh.splits(len(shape))), None)
        return adamw.LeafShard(p_sh.mesh, tuple(a for _, a in p_sh.splits(len(shape))), zero1)

    return {n: leaf(state_sh.params[n], state_sh.opt.m[n], state_sh.shapes[n])
            for n in state_sh.params}


def init_state(model, tcfg: TrainConfig = TrainConfig(), state_sh=None) -> TrainState:
    """The state of ``model`` as its parameters stand, moments at zero (on
    their ZeRO-1 blocks when ``state_sh`` lays the state out)."""
    params = dict(model.named_parameters())
    return TrainState(params=params,
                      opt=adamw.init(params, _opt_dtype(tcfg), adam_shards(state_sh)),
                      comm=(), step=0)


def grad_shapes(model) -> dict:
    """The gradient tree's full shapes in the reference's layout, as meta
    tensors (what ``init_grad_states`` reads)."""
    return registry.param_shapes(model)


def state_shapes(model, grad_chunnels: Sequence[StepChunnel],
                 tcfg: TrainConfig = TrainConfig()) -> TrainState:
    """A state of ``model``'s structure with every leaf's full shape, as
    meta tensors (what ``Checkpointer.restore`` fills)."""
    shapes = registry.param_shapes(model)
    params = unstack_layers(shapes, model.stacks())
    dtype = _opt_dtype(tcfg)
    moments = lambda: {n: torch.empty(t.shape, dtype=dtype, device="meta")  # noqa: E731
                       for n, t in params.items()}
    comm = init_grad_states(grad_chunnels, shapes)
    comm = T.map(lambda x: torch.empty(x.shape, dtype=x.dtype, device="meta")
                 if isinstance(x, torch.Tensor) else x, comm)
    return TrainState(params=params, opt=adamw.AdamWState(m=moments(), v=moments(), count=0),
                      comm=comm, step=0)


# ---------------------------------------------------------------------------
# Layout on a mesh
# ---------------------------------------------------------------------------


def _zero1_pod(spec: P, shape, mesh) -> P:
    """ZeRO-1 over the pod axis: optimizer moments additionally shard their
    FSDP ('data') dim over 'pod'. Params stay pod-replicated; the update's
    pod all-gather is the standard ZeRO-1 cost."""
    if "pod" not in mesh.axis_names:
        return spec
    pod = mesh.shape["pod"]
    data = mesh.shape.get("data", 1)
    out = []
    for dim, ax in zip(shape, tuple(spec) + (None,) * (len(shape) - len(spec))):
        if ax == "data" and dim % (data * pod) == 0:
            out.append(("data", "pod"))
        else:
            out.append(ax)
    return P(*out)


def _drop_axes(spec: P, axes) -> P:
    def keep(e):
        if e is None:
            return None
        kept = tuple(a for a in (e if isinstance(e, tuple) else (e,)) if a not in axes)
        return kept or None
    return P(*(keep(e) for e in spec))


class StateShardings(NamedTuple):
    """``TrainState``'s shardings, leaf for leaf, and each parameter's full
    shape by name."""
    params: dict
    opt: adamw.AdamWState
    comm: Any
    step: NamedSharding
    shapes: dict

    def state(self) -> TrainState:
        """The shardings as a tree of ``TrainState``'s structure."""
        return TrainState(self.params, self.opt, self.comm, self.step)


def shardings_for(model, mesh, sh: ShardingConfig, grad_chunnels=()) -> StateShardings:
    """The state's shardings, the reference's ``shardings_for`` (the batch's
    are ``local_rows``'): parameters by ``param_spec`` (less the axes the
    transport takes manual), moments by ``_zero1_pod``, error-feedback
    residuals by the parameters' specs in the reference's layout, counters
    and the step replicated."""
    shapes = registry.param_shapes(model)
    manual = stack_manual_axes(grad_chunnels) & set(mesh.axis_names)
    specs = registry.param_specs(model, sh, mesh)
    if manual:
        specs = T.map(lambda s: _drop_axes(s, manual), specs)
    ns = lambda spec: NamedSharding(mesh, spec)  # noqa: E731
    stacks = model.stacks()
    order = [n for n, _ in model.named_parameters()]
    p_specs = per_layer(specs, stacks)
    m_specs = per_layer(T.map(lambda s, t: _zero1_pod(s, tuple(t.shape), mesh), specs, shapes),
                        stacks)
    full = {n: tuple(t.shape) for n, t in unstack_layers(shapes, stacks).items()}
    comm = []
    for st in init_grad_states(grad_chunnels, shapes):
        if st == ():
            comm.append(())
        elif isinstance(st, dict) and "step" in st:
            comm.append(T.map(lambda _: ns(P()), st))
        else:
            comm.append(T.map(ns, specs))
    return StateShardings(
        params={n: ns(p_specs[n]) for n in order},
        opt=adamw.AdamWState(m={n: ns(m_specs[n]) for n in order},
                             v={n: ns(m_specs[n]) for n in order}, count=ns(P())),
        comm=tuple(comm), step=ns(P()), shapes={n: full[n] for n in order})


def model_layout(state_sh: StateShardings) -> Optional[Layout]:
    """The model's ``sharding.Layout`` from the state's shardings, or None
    when they split no parameter."""
    mesh = next(iter(state_sh.params.values())).mesh
    layout = Layout(mesh, {n: s.spec for n, s in state_sh.params.items()}, state_sh.shapes)
    return layout if any(layout.splits.values()) else None


def place(tree, shardings):
    """Each leaf of ``tree`` (full tensors) cut to this rank's block by its
    sharding in ``shardings`` (a tree of the same structure)."""
    return T.map(lambda x, s: s.local(x).clone() if isinstance(x, torch.Tensor) else x,
                 tree, shardings)


def gathered(tree, shardings, op: str = "gather_state"):
    """Each leaf of ``tree`` (this rank's blocks) gathered to its full
    tensor; every rank of the mesh calls it."""
    return T.map(lambda x, s: s.full(x, op) if isinstance(x, torch.Tensor) else x,
                 tree, shardings)


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


def _mean_auto(grads: dict, mesh, axis: str, layout) -> dict:
    """The mean over ``axis`` of each leaf: a leaf split over it holds its
    block of the sum already (its gather's backward), the rest is
    all-reduced."""
    n = mesh.shape[axis]
    split = {k for k in grads if layout is not None and axis in layout.axes(k)}
    rest = collectives.pmean_tree({k: g for k, g in grads.items() if k not in split}, mesh, axis)
    return {k: grads[k] / n if k in split else rest[k] for k in grads}


def _agree_over(grads: dict, mesh, axis: str, layout) -> dict:
    """Over ``axis``, an axis the batch is replicated on (``model``), every
    rank computed each gradient from the same rows and parameters, but not
    bit for bit alike (a library's kernels round by the alignment of their
    operands): each leaf not split over the axis is averaged over it, so
    that its update, and the parameter, stay equal on every rank of it.
    Under the compute split over ``model`` those leaves' gradients are
    equal up to rounding too: the "f" conjugates sum their inputs'
    cotangents over ``model``, and a replicated leaf that the ranks read in
    parts (the SSM's ``conv_b``, ``dt_bias``, ``D``, the sLSTM's ``r``), on their own
    positions (the norms' scales, the moe router and banks of ``grouped``
    on the rows gathered over S) or through a mesh dispatch (the router)
    sums its own. This mean sums nothing a second time."""
    rep = {k: g for k, g in grads.items() if layout is None or axis not in layout.axes(k)}
    if not rep:
        return grads
    rep = collectives.pmean_tree(rep, mesh, axis, op="grad_agree")
    return {k: rep.get(k, g) for k, g in grads.items()}


def make_train_step(model, tcfg: TrainConfig, grad_chunnels: Sequence[StepChunnel],
                    mesh, state_sh: Optional[StateShardings] = None) -> Callable:
    """Returns step(state, batch) -> (state, metrics); ``batch`` is the
    global batch as numpy arrays. ``state_sh`` lays the state out (the
    model must be sharded by the same layout, ``model_layout``)."""
    lr_fn = adamw.lr_schedule(tcfg)
    manual = stack_manual_axes(grad_chunnels) & set(mesh.axis_names)
    batch_axes = [a for a in BATCH_AXES if a in mesh.axis_names and mesh.shape[a] > 1]
    auto = [a for a in batch_axes if a not in manual]
    shared = [a for a in mesh.axis_names if a not in BATCH_AXES and mesh.shape[a] > 1]
    ctx = {"mesh": mesh}
    stacks = model.stacks()
    n_mb = max(tcfg.microbatches, 1)
    layout = model_layout(state_sh) if state_sh is not None else model.layout
    shards = adam_shards(state_sh)
    if grad_chunnels and layout is not None and any(layout.splits.values()):
        ctx["shards"] = GradShards.of_layout(layout, stacks)

    def grads_of(batch, batch_split: int) -> torch.Tensor:
        """Backward of the local batch's mean loss into the parameters'
        ``.grad``, over ``n_mb`` microbatches; returns the loss. The local
        rows are one of ``batch_split`` blocks of the global batch."""
        rows = batch["tokens"].shape[0]
        if rows % n_mb:
            raise ValueError(f"{rows} local rows do not split into {n_mb} microbatches")
        per = rows // n_mb
        total = torch.zeros((), dtype=torch.float32, device=mesh.device)
        for i in range(n_mb):
            mb = {k: v[i * per:(i + 1) * per] for k, v in batch.items()}
            with span("train.forward"):
                loss = registry.loss(model, mb, batch_split=batch_split)
            scaled = loss / n_mb
            with span("train.backward"):
                scaled.backward()
            total = total + loss.detach() / n_mb
        return total

    def step_fn(state: TrainState, batch) -> tuple:
        with span("train.step"):
            return _step(state, batch)

    def _step(state: TrainState, batch) -> tuple:
        with span("train.feed"):
            local = local_rows(batch, mesh)
        for p in state.params.values():
            p.grad = None
        loss = grads_of(local, batch["tokens"].shape[0] // local["tokens"].shape[0])
        grads = {n: p.grad for n, p in state.params.items()}
        with span("train.grad_sync"):  # the transport's seam
            for a in auto:  # what the reference's partitioner averages
                grads = _mean_auto(grads, mesh, a, layout)
            for a in shared:
                grads = _agree_over(grads, mesh, a, layout)
            comm = state.comm
            if grad_chunnels:  # on the rank's own shard (ctx["shards"])
                tree, comm = apply_grad_stack(grad_chunnels, stack_layers(grads, stacks), comm,
                                              ctx)
                grads = unstack_layers(tree, stacks)
        with span("train.optimizer"):
            params, opt, metrics = adamw.update(grads, state.opt, state.params,
                                                lr_fn(state.step), tcfg, shards)
        for p in state.params.values():
            p.grad = None
        # a step's frames can outlive it (the first step's are held through
        # a lazy import made inside its checkpointed forward, until the
        # cyclic collector runs): they must not hold a set of gradients
        # into the next step's backward
        del grads
        with span("train.metrics"):
            values = _mean_over(torch.stack([loss, metrics["grad_norm"].to(loss.device)]),
                                mesh, batch_axes + shared).tolist()
        return (TrainState(params, opt, comm, state.step + 1),
                {"loss": values[0], "grad_norm": values[1]})

    return step_fn
