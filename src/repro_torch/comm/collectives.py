"""Collective implementations over a mesh axis (the gradient transports).

The counterpart of ``src/repro/comm/collectives.py``, on ``torch.distributed``.
These are the alternative implementations behind the gradient-transport
Select: all compute the same all-reduce, with different schedules and wire
formats, hence different collective-roofline terms:

  psum_tree          the framework's all-reduce (one fused AR)
  ring_tree          explicit ring reduce-scatter + all-gather from
                     point-to-point sends: 2(n-1) steps to the next rank
  hierarchical_tree  reduce-scatter over the fast axis, all-reduce over the
                     slow axis on 1/|fast| shards, then all-gather — per-rank
                     slow-tier bytes divided by |fast|
  compressed_tree    int8 block-quantized all-gather over the slow axis
                     (4x fewer bytes than f32) with error feedback upstream

Where the reference runs inside a ``shard_map`` over named axes, these take
the rank's :class:`repro_torch.launch.mesh.Mesh` and an axis name; a tree's
leaves are the rank's local values. A tree is flattened in the reference's
leaf order (``repro_torch.tree``), so the flat vector, and with it every
block the int8 wire quantizes, has the reference's boundaries. On a mesh
that splits the gradient the tree is a rank's view of it
(``train.gradshard``): its blocks of the leaves whose blocks are whole
blocks of the wire, the rest whole, so its flat vector is whole blocks of
the reference's, in order.

Backends. Under ``nccl`` the tensors stay on the GPU and the framework's
all-reduce, all-gather and reduce-scatter run. Under ``gloo`` every tensor
of a collective is copied to the host first and back after (gloo's
collectives and sends work on host memory), and the reduce-scatter is a
ring of point-to-point sends, which gloo may lack: each rank moves the
bytes the reference's schedule moves, and no all-reduce ever stands in for
the ring or the reduce-scatter.

``SENT`` counts the bytes this rank hands to the transport, keyed
``"<operation>@<axis>"``: a point-to-point send its size; an all-reduce (sum
or max) of B bytes over n ranks 2(n-1)/n·B, an all-gather of B bytes (n-1)·B
and an all-to-all of n blocks of b bytes (n-1)·b, as their ring or direct
schedules send them (the library's own algorithm may differ). The serving
path's all-to-all (``all_to_all@model``, the MoE dispatch) and max
(``all_reduce_max@model``, the flash-decode combine) are counted so.

Sharded parameters (``models.sharding.Layout``) are gathered for the forward
by :func:`gather_param`, counted as ``gather_param@<axis>``; its backward
over a batch axis is a reduce-scatter, ``grad_reduce_scatter@<axis>``.
The MoE dispatches train through differentiable all-to-all, gather and
sum (:func:`all_to_all_grad`, :func:`gather_grad`, :func:`all_reduce_grad`,
:func:`replicated`, :func:`replicated_block`), whose backwards count as
``grad_<op>@<axis>``. The compute split over ``model``
(``models.pshard``) runs on two of them: :func:`replicated`, Megatron's "f"
(its backward sums a bfloat16 cotangent in float32), and
:func:`sum_partials`, its "g": the row products' bfloat16 partial outputs
summed in float32 and rounded once, counted as ``sum_partials@<axis>``.
A parameter that the ranks of ``model`` each use a part of is gathered by
``gather_param(..., downstream="partial")``: its backward is a
reduce-scatter sum over ``model`` too.

The sequence-parallel residual (``models.pshard``'s ``seq``) runs on two
conjugates over the sequence dim (dim 1) instead: :func:`gather_seq`
(``gather_seq``), the all-gather of the rank's positions before the column
products, whose backward is the float32 reduce-scatter sum of the ranks'
cotangents (``grad_scatter_seq``), and :func:`scatter_seq`
(``scatter_seq``), the float32 reduce-scatter of the row products'
partials, rounded once, whose backward all-gathers the cotangent
(``grad_gather_seq``). The vocabulary-parallel embedding scatters its
bfloat16 lookups the same way (``scatter_embed``; a token's row is on one
rank, so the sum is exact) or, on a residual that stays whole, sums them
(``embed_sum``); serving's prefill takes the last position from the rank
that holds it (:func:`broadcast`, ``last_row``) and gathers the ranks'
logits (``gather_logits``); the vocabulary-parallel loss sums its row
maxima, gold logits and sums of exponentials over ``model`` (``loss_max``,
``loss_gold``, ``loss_sumexp``). A broadcast counts (n-1)·B on its source
and nothing elsewhere. xLSTM's sLSTM, split by channels, all-gathers its
output's channels into the residual (``gather_channels``, its backward the
rank's own block), and the moe family's serving ``grouped`` on the rank's
experts sums its float32 partial combines (``sum_partials``).
"""
from __future__ import annotations

import threading
from collections import Counter
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch import tree as T
from repro_torch.comm import compress
from repro_torch.launch.mesh import BATCH_AXES

#: bytes this process sent through the collectives, by operation
SENT: Counter = Counter()
_SENT_LOCK = threading.Lock()


def _count(op: str, axis: str, nbytes: float) -> None:
    with _SENT_LOCK:
        SENT[f"{op}@{axis}"] += int(nbytes)


def sent_by_axis(sent=None) -> dict:
    """Bytes of ``sent`` (``SENT`` by default) summed by axis."""
    out: dict = {}
    for key, n in (SENT if sent is None else sent).items():
        axis = key.rsplit("@", 1)[-1]
        out[axis] = out.get(axis, 0) + n
    return out


def dcn_bytes_factor(schedule: str, *, n_fast: int = 1, sync_every: int = 1,
                     wire_ratio: float = 1.0) -> float:
    """Per-payload-byte DCN traffic of each schedule, relative to one fused
    f32 all-reduce — the ``dcn_bytes_per_byte`` cost-model term behind the
    gradient-transport Select:

      psum/ring/xla   1.0   (full f32 gradients cross the slow tier)
      hierarchical    1/n_fast  (each chip moves only its RS shard over DCN)
      compressed      wire_ratio (see ``compress.int8_wire_ratio``)
      hier_compressed wire_ratio/n_fast
      localsgd        1/sync_every (full sync every H steps, amortized)
    """
    if schedule in ("hierarchical",):
        return 1.0 / max(n_fast, 1)
    if schedule in ("compressed", "compressed_int8", "cag"):
        return wire_ratio
    if schedule in ("hier_compressed", "hiercag"):
        return wire_ratio / max(n_fast, 1)
    if schedule == "localsgd":
        return 1.0 / max(sync_every, 1)
    return 1.0  # xla / psum / ring


# ---------------------------------------------------------------------------
# Primitives over one axis of the mesh
# ---------------------------------------------------------------------------


def _staged(mesh, t: torch.Tensor) -> torch.Tensor:
    """``t`` where the backend can read it: on the host under gloo."""
    return t.cpu() if mesh.backend == "gloo" and t.device.type != "cpu" else t


def all_reduce_sum(x: torch.Tensor, mesh, axis: str, *, op: str = "all_reduce") -> torch.Tensor:
    """The sum of ``x`` over ``axis`` (a new tensor)."""
    n = mesh.shape[axis]
    if n == 1:
        return x.clone()
    buf = _staged(mesh, x)
    buf = buf.clone() if buf is x else buf
    dist.all_reduce(buf, group=mesh.group(axis))
    _count(op, axis, 2 * (n - 1) / n * buf.numel() * buf.element_size())
    return buf.to(x.device)


def all_gather(x: torch.Tensor, mesh, axis: str, *, op: str = "all_gather") -> torch.Tensor:
    """(n, *x.shape): every rank's ``x`` along ``axis``, by axis index."""
    n = mesh.shape[axis]
    if n == 1:
        return x.unsqueeze(0).clone()
    src = _staged(mesh, x.contiguous())
    _count(op, axis, (n - 1) * src.numel() * src.element_size())
    if mesh.backend == "gloo":
        parts = [torch.empty_like(src) for _ in range(n)]
        dist.all_gather(parts, src, group=mesh.group(axis))
        return torch.stack(parts).to(x.device)
    out = torch.empty((n,) + tuple(src.shape), dtype=src.dtype, device=src.device)
    dist.all_gather_into_tensor(out, src, group=mesh.group(axis))
    return out


def all_reduce_max(x: torch.Tensor, mesh, axis: str, *,
                   op: str = "all_reduce_max") -> torch.Tensor:
    """The elementwise maximum of ``x`` over ``axis`` (a new tensor): the
    reference's ``pmax``."""
    n = mesh.shape[axis]
    if n == 1:
        return x.clone()
    buf = _staged(mesh, x)
    buf = buf.clone() if buf is x else buf
    dist.all_reduce(buf, op=dist.ReduceOp.MAX, group=mesh.group(axis))
    _count(op, axis, 2 * (n - 1) / n * buf.numel() * buf.element_size())
    return buf.to(x.device)


def all_to_all(x: torch.Tensor, mesh, axis: str, *, op: str = "all_to_all") -> torch.Tensor:
    """Block ``j`` of ``x`` (n, ...) goes to the rank at index ``j`` along
    ``axis``; the result (n, ...) is indexed by source rank: the reference's
    ``all_to_all(x, axis, split_axis=0, concat_axis=0, tiled=False)``.
    Point-to-point sends to each peer under gloo, the library's all-to-all
    under NCCL."""
    n = mesh.shape[axis]
    if x.shape[0] != n:
        raise ValueError(f"all_to_all over {axis} ({n} ranks) of a leading dim {x.shape[0]}")
    if n == 1:
        return x.clone()
    src = _staged(mesh, x.contiguous())
    out = torch.empty_like(src)
    _count(op, axis, (n - 1) * src[0].numel() * src.element_size())
    if mesh.backend != "gloo":
        dist.all_to_all_single(out, src, group=mesh.group(axis))
        return out
    members, i = mesh.members(axis), mesh.coords[axis]
    group = mesh.group(axis)
    out[i] = src[i]
    ops = []
    for j in range(n):
        if j != i:
            ops += [dist.P2POp(dist.isend, src[j], members[j], group),
                    dist.P2POp(dist.irecv, out[j], members[j], group)]
    for w in dist.batch_isend_irecv(ops):
        w.wait()
    return out.to(x.device)


def _exchange(mesh, axis: str, send: torch.Tensor, recv: torch.Tensor,
              op: str = "send") -> None:
    """One ring step: ``send`` to the next rank along ``axis``, ``recv``
    from the previous one."""
    members, i = mesh.members(axis), mesh.coords[axis]
    n = len(members)
    group = mesh.group(axis)
    ops = [dist.P2POp(dist.isend, send, members[(i + 1) % n], group),
           dist.P2POp(dist.irecv, recv, members[(i - 1) % n], group)]
    for w in dist.batch_isend_irecv(ops):
        w.wait()
    _count(op, axis, send.numel() * send.element_size())


def broadcast(x: torch.Tensor, mesh, axis: str, src: int, *,
              op: str = "broadcast") -> torch.Tensor:
    """The ``x`` of the rank at index ``src`` along ``axis``, on every rank
    of it (a new tensor; the other ranks' ``x`` gives only the shape)."""
    n = mesh.shape[axis]
    if n == 1:
        return x.clone()
    buf = _staged(mesh, x.contiguous())
    buf = buf.clone() if buf is x else buf
    dist.broadcast(buf, src=mesh.members(axis)[src], group=mesh.group(axis))
    if mesh.coords[axis] == src:
        _count(op, axis, (n - 1) * buf.numel() * buf.element_size())
    return buf.to(x.device)


def reduce_scatter(x2d: torch.Tensor, mesh, axis: str, *,
                   op: str = "reduce_scatter") -> torch.Tensor:
    """Row ``i`` of the sum over ``axis`` of ``x2d`` (n, m), for the rank at
    index ``i``: the reference's ``psum_scatter(..., tiled=False)``. A ring
    of n-1 point-to-point steps under gloo."""
    n = mesh.shape[axis]
    if n == 1:
        return x2d[0].clone()
    if mesh.backend != "gloo":
        out = torch.empty(x2d.shape[1:], dtype=x2d.dtype, device=x2d.device)
        dist.reduce_scatter_tensor(out, x2d.contiguous(), group=mesh.group(axis))
        _count(op, axis, (n - 1) * out.numel() * out.element_size())
        return out
    acc = _staged(mesh, x2d)
    acc = acc.clone() if acc is x2d else acc  # the host copy is new already
    r = mesh.coords[axis]
    buf = torch.empty_like(acc[0])
    for s in range(n - 1):
        _exchange(mesh, axis, acc[(r - s - 1) % n], buf, op)
        acc[(r - s - 2) % n] += buf
    return acc[r].to(x2d.device)


def gather_dim(shard: torch.Tensor, mesh, axis: str, dim: int, *,
               op: str = "all_gather") -> torch.Tensor:
    """Every rank's ``shard`` along ``axis``, joined on ``dim`` by axis
    index: the full tensor of a leaf split over ``axis`` on ``dim``."""
    if mesh.shape[axis] == 1:
        return shard
    dim = dim % shard.dim()
    parts = all_gather(shard, mesh, axis, op=op)  # (n, *shard.shape)
    full = list(shard.shape)
    full[dim] *= parts.shape[0]
    return parts.movedim(0, dim).reshape(full)


def scatter_dim(x: torch.Tensor, mesh, axis: str, dim: int, *,
                op: str = "reduce_scatter") -> torch.Tensor:
    """This rank's block along ``dim`` of the sum over ``axis`` of ``x``
    (:func:`reduce_scatter` of ``x`` cut into ``|axis|`` blocks on ``dim``):
    :func:`gather_dim`'s conjugate."""
    n = mesh.shape[axis]
    if n == 1:
        return x
    blocks = x.movedim(dim, 0)
    rows = blocks.reshape((n, blocks.shape[0] // n) + tuple(blocks.shape[1:]))
    own = reduce_scatter(rows.reshape(n, -1), mesh, axis, op=op)
    return own.reshape(rows.shape[1:]).movedim(0, dim).contiguous()


def _own_block(full: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    per = full.shape[dim] // mesh.shape[axis]
    return full.narrow(dim, mesh.coords[axis] * per, per)


def gather_param(shard: torch.Tensor, mesh, axis: str, dim: int, *,
                 downstream: Optional[str] = None) -> torch.Tensor:
    """The parameter block ``shard``, split over ``axis`` on ``dim``, joined
    with every other rank's along ``axis``; differentiable. The backward
    depends on the axis: over an axis the batch is dealt out on (``pod``,
    ``data``), every rank's gradient is a part of the sum, so it is a
    reduce-scatter sum; over an axis the batch is replicated on (``model``),
    every rank computed the same gradient, so it is the rank's own block
    with no sum (a sum would multiply it by the axis size): :func:`gather_grad`
    with the downstream of each. ``downstream="partial"`` over ``model``: the
    ranks each use a part of the whole (the compute split's ``in_proj``),
    so their gradients are parts of a sum."""
    if mesh.shape[axis] == 1:
        return shard
    if downstream is None:
        downstream = "partial" if axis in BATCH_AXES else "replicated"
    _check_downstream(downstream)
    return _Gather.apply(shard, mesh, axis, dim, downstream, "gather_param")


# ---------------------------------------------------------------------------
# Differentiable collectives (the MoE dispatches in training)
# ---------------------------------------------------------------------------
#
# The reference differentiates its dispatches through ``shard_map``, whose
# transpose rules these follow. The port's compute model differs: each rank
# of a ``model`` group holds the same rows and computes the whole forward on
# them, and each rank of a batch axis holds its own rows' loss (the step
# averages the gradients over the batch axes afterwards). So a collective's
# backward depends on what consumes its output: ``downstream="replicated"``
# when every rank of the axis repeats the same computation on it (its
# cotangent is the same whole one on every rank), ``"partial"`` when each
# rank's copy feeds only that rank's own part (the cotangents are parts of
# a sum). The forwards count their bytes under the forward-only
# collectives' names; the backwards under ``grad_<op>``.

DOWNSTREAM = ("replicated", "partial")


def _check_downstream(downstream: str) -> None:
    if downstream not in DOWNSTREAM:
        raise ValueError(f"downstream {downstream!r}: use one of {DOWNSTREAM}")


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return all_to_all(x.detach(), mesh, axis)

    @staticmethod
    def backward(ctx, g):
        # the exchange is its own transpose: block j of rank i went to rank j
        # as its block i
        return all_to_all(g.contiguous(), ctx.mesh, ctx.axis, op="grad_all_to_all"), None, None


def all_to_all_grad(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """:func:`all_to_all`, differentiable: its backward is the all-to-all of
    the cotangent (``grad_all_to_all``)."""
    if mesh.shape[axis] == 1:
        return x
    return _AllToAll.apply(x, mesh, axis)


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, shard, mesh, axis, dim, downstream, op):
        ctx.mesh, ctx.axis, ctx.dim, ctx.downstream = mesh, axis, dim, downstream
        return gather_dim(shard.detach(), mesh, axis, dim, op=op)

    @staticmethod
    def backward(ctx, g):
        mesh, axis, dim = ctx.mesh, ctx.axis, ctx.dim
        if ctx.downstream == "replicated":
            return _own_block(g, mesh, axis, dim).contiguous(), None, None, None, None, None
        return (scatter_dim(g, mesh, axis, dim, op="grad_reduce_scatter"),
                None, None, None, None, None)


def gather_grad(shard: torch.Tensor, mesh, axis: str, dim: int, *,
                downstream: str, op: str = "all_gather") -> torch.Tensor:
    """:func:`gather_dim`, differentiable, counted as ``op``. Its backward:
    the rank's own block of the cotangent where the gathered tensor feeds a
    replicated computation (the reference's all-gather whose output every
    rank of the axis uses alike), a reduce-scatter sum
    (``grad_reduce_scatter``) where each rank uses it for its own part."""
    _check_downstream(downstream)
    if mesh.shape[axis] == 1:
        return shard
    return _Gather.apply(shard, mesh, axis, dim, downstream, op)


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, downstream, op):
        ctx.mesh, ctx.axis, ctx.downstream = mesh, axis, downstream
        return all_reduce_sum(x.detach(), mesh, axis, op=op)

    @staticmethod
    def backward(ctx, g):
        if ctx.downstream == "replicated":
            return g, None, None, None, None
        return (all_reduce_sum(g, ctx.mesh, ctx.axis, op="grad_all_reduce"),
                None, None, None, None)


def all_reduce_grad(x: torch.Tensor, mesh, axis: str, *, downstream: str,
                    op: str = "all_reduce") -> torch.Tensor:
    """:func:`all_reduce_sum`, differentiable. Its backward passes the
    cotangent unchanged where the sum feeds a replicated computation (each
    rank's part enters the one sum once), and sums the cotangents over the
    axis (``grad_all_reduce``) where each rank's copy feeds its own part."""
    _check_downstream(downstream)
    if mesh.shape[axis] == 1:
        return x
    return _AllReduce.apply(x, mesh, axis, downstream, op)


def sum_partials(x: torch.Tensor, mesh, axis: str, dtype: torch.dtype) -> torch.Tensor:
    """The sum over ``axis`` of ``x``, each rank's partial output of a row
    product (Megatron's "g"), in float32, rounded once to ``dtype``
    (``sum_partials``); the backward passes the cotangent unchanged, as the
    sum feeds a computation every rank of the axis repeats."""
    if mesh.shape[axis] == 1:
        return x.to(dtype)
    return all_reduce_grad(x.float(), mesh, axis, downstream="replicated",
                           op="sum_partials").to(dtype)


# ---------------------------------------------------------------------------
# The sequence-parallel residual's conjugates (dim 1, the sequence)
# ---------------------------------------------------------------------------


class _GatherSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dtype):
        ctx.mesh, ctx.axis, ctx.dtype = mesh, axis, x.dtype
        return gather_dim(x.detach(), mesh, axis, 1, op="gather_seq").to(dtype)

    @staticmethod
    def backward(ctx, g):
        # the ranks' cotangents are parts of a sum: summed in float32, rounded once
        own = scatter_dim(g.float(), ctx.mesh, ctx.axis, 1, op="grad_scatter_seq")
        return own.to(ctx.dtype), None, None, None


def gather_seq(x: torch.Tensor, mesh, axis: str,
               dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Every rank's positions of ``x`` (B, S/n, ...) along ``axis``, joined on
    the sequence dim by axis index (B, S, ...), as ``dtype`` (``x``'s where
    None; sent as ``x``'s): the all-gather before a block that reads every
    position (``gather_seq``). Each rank uses the whole for its own part
    (its heads, its channels, its own positions' outputs), so the backward
    is the reduce-scatter sum of the ranks' cotangents, in float32 rounded
    once to ``x``'s dtype (``grad_scatter_seq``): a float32 ``dtype`` keeps
    the ranks' partial cotangents unrounded until that sum."""
    dtype = x.dtype if dtype is None else dtype
    if mesh.shape[axis] == 1:
        return x.to(dtype)
    return _GatherSeq.apply(x, mesh, axis, dtype)


class _ScatterSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dtype, op):
        ctx.mesh, ctx.axis, ctx.dtype = mesh, axis, x.dtype
        return scatter_dim(x.detach(), mesh, axis, 1, op=op).to(dtype)

    @staticmethod
    def backward(ctx, g):
        full = gather_dim(g.contiguous(), ctx.mesh, ctx.axis, 1, op="grad_gather_seq")
        return full.to(ctx.dtype), None, None, None, None


def scatter_seq(x: torch.Tensor, mesh, axis: str, dtype: torch.dtype, *,
                op: str = "scatter_seq") -> torch.Tensor:
    """This rank's positions (B, S/n, ...) of the sum over ``axis`` of ``x``
    (B, S, ...), rounded once to ``dtype``: the reduce-scatter after the row
    products (their float32 partials, ``scatter_seq``), or of the
    vocabulary-parallel embedding's lookups (``op="scatter_embed"``). Its
    backward all-gathers the cotangent over the sequence
    (``grad_gather_seq``)."""
    if mesh.shape[axis] == 1:
        return x.to(dtype)
    return _ScatterSeq.apply(x, mesh, axis, dtype, op)


class _Replicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        # a bfloat16 cotangent (the split's activations) is summed in float32
        # and rounded once
        total = all_reduce_sum(g.float(), ctx.mesh, ctx.axis, op="grad_all_reduce")
        return total.to(g.dtype), None, None


def replicated(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """``x``, an input that enters a computation split over ``axis`` whole on
    every rank of it (the router weight of a dispatch, Megatron's "f" before
    the compute split's column products): the identity, whose backward sums
    the ranks' cotangents over ``axis`` (``grad_all_reduce``), as
    ``shard_map``'s transpose sums an input's cotangent over the manual axes
    its spec does not name."""
    if mesh.shape[axis] == 1:
        return x
    return _Replicated.apply(x, mesh, axis)


class _ReplicatedBlock(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return _own_block(x, mesh, axis, dim)

    @staticmethod
    def backward(ctx, g):
        full = gather_dim(g.contiguous(), ctx.mesh, ctx.axis, ctx.dim, op="grad_all_gather")
        return full, None, None, None


def replicated_block(x: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    """This rank's block along ``dim`` of ``x``, a tensor whole on every rank
    of ``axis`` (a dispatch's rows before its sequence slice, the banks
    before its experts): the slice, whose backward is the sum over ``axis``
    of the ranks' cotangents (:func:`replicated`'s) less its zeros, the
    ranks' disjoint blocks all-gathered (``grad_all_gather``)."""
    if mesh.shape[axis] == 1:
        return x
    return _ReplicatedBlock.apply(x, mesh, axis, dim)


# ---------------------------------------------------------------------------
# Trees
# ---------------------------------------------------------------------------


def _flatten(tree) -> Tuple[torch.Tensor, list]:
    leaves = T.leaves(tree)
    if not leaves:
        return torch.zeros((0,)), leaves
    return torch.cat([l.reshape(-1).to(torch.float32) for l in leaves]), leaves


def _unflatten(flat: torch.Tensor, tree, leaves) -> object:
    out, off = [], 0
    for l in leaves:
        n = l.numel()
        out.append(flat[off:off + n].view(l.shape).to(l.dtype))
        off += n
    return T.unflatten(tree, out)


def psum_tree(tree, mesh, axis: str):
    """The sum over ``axis`` of every leaf, as one all-reduce of the
    flattened tree (the same bytes as one per leaf)."""
    flat, leaves = _flatten(tree)
    return _unflatten(all_reduce_sum(flat, mesh, axis), tree, leaves)


def pmean_tree(tree, mesh, axis: str, *, op: str = "all_reduce"):
    n = mesh.shape[axis]
    flat, leaves = _flatten(tree)
    return _unflatten(all_reduce_sum(flat, mesh, axis, op=op) / n, tree, leaves)


def ring_allreduce(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """Ring all-reduce of a flat vector via 2(n-1) point-to-point steps,
    chunk for chunk the reference's schedule."""
    n = mesh.shape[axis]
    if n == 1:
        return x
    rank = mesh.coords[axis]
    size = x.shape[0]
    pad = (-size) % n
    chunks = _staged(mesh, torch.nn.functional.pad(x, (0, pad))).reshape(n, -1).clone()
    recv = torch.empty_like(chunks[0])
    for i in range(1, n):  # reduce-scatter
        _exchange(mesh, axis, chunks[(rank - i + 1) % n], recv)
        chunks[(rank - i) % n] += recv
    my = (rank + 1) % n
    cur = chunks[my].clone()
    out = torch.zeros_like(chunks)
    out[my] = cur
    for i in range(1, n):  # all-gather
        nxt = torch.empty_like(cur)
        _exchange(mesh, axis, cur, nxt)
        out[(rank - i + 1) % n] = nxt
        cur = nxt
    return out.reshape(-1)[:size].to(x.device)


def ring_tree(tree, mesh, axis: str):
    flat, leaves = _flatten(tree)
    return _unflatten(ring_allreduce(flat, mesh, axis), tree, leaves)


def _hierarchical(flat: torch.Tensor, mesh, fast_axis: str, slow, lengths=None):
    """RS(fast) -> ``slow(shard)`` -> AG(fast), with the reference's padding
    of the flat vector to a multiple of |fast|. ``lengths``: the rank's
    vector is its view of a larger one (``train.gradshard``), and
    ``lengths[d]`` of its elements, in order, lie in the reference's chunk
    ``d``: each chunk is a row, padded to the longest, and the rank at index
    ``d`` along ``fast_axis`` reduces its row's ``lengths[d]`` elements."""
    n_fast = mesh.shape[fast_axis]
    if lengths is None:
        pad = (-flat.shape[0]) % n_fast
        xp = torch.nn.functional.pad(flat, (0, pad))
        shard = reduce_scatter(xp.reshape(n_fast, -1), mesh, fast_axis)
        shard = slow(shard)
        full = all_gather(shard, mesh, fast_axis)
        return full.reshape(-1)[:flat.shape[0]]
    if len(lengths) != n_fast or sum(lengths) != flat.shape[0]:
        raise ValueError(f"chunk lengths {tuple(lengths)} for {flat.shape[0]} elements over "
                         f"{fast_axis} ({n_fast})")
    width = max(lengths)
    rows = flat.new_zeros((n_fast, width))
    for d, part in enumerate(torch.split(flat, list(lengths))):
        rows[d, :part.shape[0]] = part
    mine = lengths[mesh.coords[fast_axis]]
    shard = slow(reduce_scatter(rows, mesh, fast_axis)[:mine])
    full = all_gather(torch.nn.functional.pad(shard, (0, width - mine)), mesh, fast_axis)
    return torch.cat([full[d, :lengths[d]] for d in range(n_fast)])


def hierarchical_tree(tree, mesh, fast_axis: str, slow_axis: str):
    """RS(fast) -> AR(slow) on 1/|fast| shards -> AG(fast).

    Balances slow-tier traffic: every rank moves only its 1/|fast| gradient
    shard across the slow tier instead of the full tree.
    """
    flat, leaves = _flatten(tree)
    out = _hierarchical(flat, mesh, fast_axis,
                        lambda s: all_reduce_sum(s, mesh, slow_axis))
    return _unflatten(out, tree, leaves)


def compressed_allgather_sum(x: torch.Tensor, mesh, axis: str, *,
                             block: int = 256) -> torch.Tensor:
    """All-reduce with an int8 block-quantized wire format over ``axis``.

    Each rank quantizes its vector (``quantize_pack``), all-gathers the
    (int8 codes, f32 scales) pair (1/4 the f32 bytes + 4/block of scales)
    and sums the n dequantized vectors in rank order in one launch of
    ``unpack_dequant_sum``.
    """
    n = mesh.shape[axis]
    if n == 1:
        return x
    q, scales = compress.quantize_int8(x, block=block)
    q_all = all_gather(q, mesh, axis)  # (n, n_blocks, block)
    s_all = all_gather(scales, mesh, axis)  # (n, n_blocks)
    return compress.dequantize_sum_int8(q_all, s_all, x.shape)


def compressed_tree(tree, mesh, slow_axis: str, *, block: int = 256):
    flat, leaves = _flatten(tree)
    out = compressed_allgather_sum(flat, mesh, slow_axis, block=block)
    return _unflatten(out, tree, leaves)


def hierarchical_compressed_tree(tree, mesh, fast_axis: str, slow_axis: str, *,
                                 block: int = 256, lengths=None):
    """Beyond-paper combination: RS(fast) -> compressed AR(slow) -> AG(fast).
    ``lengths``: ``tree`` is a rank's view, its elements in each of the
    reference's chunks (:func:`_hierarchical`), so that each chunk's blocks
    start where the reference's do."""
    flat, leaves = _flatten(tree)
    out = _hierarchical(flat, mesh, fast_axis,
                        lambda s: compressed_allgather_sum(s, mesh, slow_axis, block=block),
                        lengths)
    return _unflatten(out, tree, leaves)
