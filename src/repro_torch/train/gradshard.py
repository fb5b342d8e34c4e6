"""Each rank's own shard of the gradient, for the gradient transports.

The reference runs every transport but ``xla`` inside a ``shard_map`` that
is manual over the transport's own axes only (``src/repro/train/step.py``):
``data`` and ``model`` stay automatic, so each device reduces over the
manual axes only the part of the gradient that the partitioner leaves it.
What it computes is defined on the logical tree: the int8 wire quantizes
blocks of the flat vector (every leaf flattened in the reference's leaf
order and concatenated), the error feedback blocks of each leaf.

The port's step holds each rank's block of every leaf (the parameters'
specs less the manual axes) and hands the transports those blocks. A plan
(:meth:`GradShards.plan`), decided from shapes alone and the same on every
rank, says for each leaf:

- **own**: every rank's block of the leaf, flattened row-major, is a union
  of whole blocks of the wire's frame. The rank puts its block on the wire
  as it is. The leaf starts on a block boundary, so those blocks are also
  the leaf's own, which the per-leaf residual quantizes.
- **whole**: otherwise. The leaf is gathered over the axes that split it
  (``gather_grad``), every rank of the group reduces all of it, as the
  reference's flat vector holds it, and keeps its block of the result. A
  maximal run of whole leaves starts and ends on block boundaries, because
  its neighbours are own.

The frame is the reference's: blocks of ``block`` elements from the start
of the flat vector, or, for the hierarchical wire, from the start of each of
its ``chunks`` chunks (the flat vector padded to a multiple of ``chunks``
and cut into as many rows, the reference's ``psum_scatter``). A rank's view
of the tree (own leaves as its blocks, whole ones full), concatenated in
leaf order, is then a sequence of the frame's blocks in order, so the codes
and scales it sends are the reference's at those blocks. The float32
transports are elementwise and take block 1, where every leaf is own.

Hazard: a leaf is own only if *every* rank's block is whole blocks (the
union of the ranks' blocks tiles the leaf into runs of one length, and
every run boundary must be a frame boundary): a whole leaf is gathered
collectively, so all ranks must decide alike.
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from repro_torch import tree as T
from repro_torch.models.sharding import P, NamedSharding
from repro_torch.models.stacking import stack_layers


def _extents(shape, sharding: NamedSharding) -> Tuple[Tuple[slice, ...], List[int]]:
    idx = sharding.index(shape)
    return idx, [len(range(*s.indices(d))) for s, d in zip(idx, shape)]


def _run_length(shape, sharding: NamedSharding) -> int:
    """The length of the contiguous runs into which the ranks' blocks of a
    ``shape`` leaf, flattened row-major, tile it: the innermost split
    dim's block extent times that dim's stride (the whole leaf when
    nothing splits it)."""
    _, per = _extents(shape, sharding)
    split = [j for j, (p, d) in enumerate(zip(per, shape)) if p != d]
    if not split:
        return math.prod(shape)
    j = split[-1]
    return per[j] * math.prod(shape[j + 1:])


def _rank_runs(shape, sharding: NamedSharding, offset: int) -> Tuple[np.ndarray, int]:
    """(the starts, in order, of the runs that make up this rank's block of a
    ``shape`` leaf at ``offset`` of the flat vector; their length)."""
    run = _run_length(shape, sharding)
    if run == math.prod(shape):
        return np.array([offset], dtype=np.int64), run
    idx, per = _extents(shape, sharding)
    j = max(k for k, (p, d) in enumerate(zip(per, shape)) if p != d)
    strides = [math.prod(shape[k + 1:]) for k in range(len(shape))]
    starts = np.array([offset + idx[j].start * strides[j]], dtype=np.int64)
    for k in range(j):
        rows = np.arange(*idx[k].indices(shape[k]), dtype=np.int64) * strides[k]
        starts = (starts[:, None] + rows[None, :]).reshape(-1)
    return starts, run


class GradPlan:
    """A transport's plan for one rank: which leaves are own, what the
    rank's view of the tree holds, and where it lies in the frame."""

    def __init__(self, shapes: Sequence[tuple], shardings: Sequence[NamedSharding],
                 block: int, chunks: int):
        self.shapes, self.shardings = list(shapes), list(shardings)
        self.block, self.chunks = block, chunks
        numels = [math.prod(s) for s in self.shapes]
        self.offsets = [int(o) for o in np.cumsum([0] + numels[:-1])] if numels else []
        self.total = n = sum(numels)
        #: the length of a chunk of the frame: the flat vector padded to a
        #: multiple of ``chunks``, cut into ``chunks`` rows
        self.width = max((n + (-n) % chunks) // chunks, 1)
        own = []
        for shape, sh, o, size in zip(self.shapes, self.shardings, self.offsets, numels):
            if block == 1 or size == 0:
                own.append(True)
                continue
            run = _run_length(shape, sh)
            p = o + run * np.arange(size // run + 1, dtype=np.int64)
            own.append(bool((((p % self.width) % block == 0) | (p == n)).all()))
        self.own: Tuple[bool, ...] = tuple(own)
        #: the elements of the rank's view of the tree
        self.numel = sum(math.prod(_extents(s, sh)[1]) if ok else size
                         for s, sh, ok, size in zip(self.shapes, self.shardings, self.own, numels))
        self._lengths = None

    def segments(self) -> Tuple[np.ndarray, np.ndarray]:
        """(starts, ends) in the flat vector of the runs that make up the
        rank's view, in order."""
        starts, ends = [], []
        for shape, sh, o, ok in zip(self.shapes, self.shardings, self.offsets, self.own):
            if ok:
                s, run = _rank_runs(shape, sh, o)
            else:
                s, run = np.array([o], dtype=np.int64), math.prod(shape)
            starts.append(s)
            ends.append(s + run)
        if not starts:
            return np.zeros(0, np.int64), np.zeros(0, np.int64)
        return np.concatenate(starts), np.concatenate(ends)

    def chunk_lengths(self) -> Tuple[int, ...]:
        """The elements of the rank's view in each chunk of the frame."""
        if self._lengths is None:
            starts, ends = self.segments()
            self._lengths = tuple(int(np.clip(np.minimum(ends, (d + 1) * self.width)
                                              - np.maximum(starts, d * self.width), 0,
                                              None).sum())
                                  for d in range(self.chunks))
        return self._lengths

    def gather(self, tree, op: str = "gather_grad"):
        """``tree`` (this rank's blocks) as the rank's view: own leaves as
        they are, whole ones gathered (every rank of the mesh calls it)."""
        leaves = T.leaves(tree)
        return T.unflatten(tree, [x if ok else sh.full(x, op)
                                  for x, sh, ok in zip(leaves, self.shardings, self.own)])

    def cut(self, tree):
        """``tree`` in the view's shapes back to this rank's blocks."""
        leaves = T.leaves(tree)
        return T.unflatten(tree, [x if ok or not sh.splits(x.dim()) else sh.local(x).clone()
                                  for x, sh, ok in zip(leaves, self.shardings, self.own)])


class GradShards:
    """The gradient tree's leaves on a mesh: their full shapes, in the
    reference's leaf order, and their shardings (the parameters' specs less
    the axes the stack takes manual). The training step passes it to the
    transports as ``ctx["shards"]``; each asks it for its plan."""

    def __init__(self, shapes: Sequence[tuple], shardings: Sequence[NamedSharding]):
        self.shapes = [tuple(s) for s in shapes]
        self.shardings = list(shardings)
        self._plans: Dict[tuple, GradPlan] = {}

    @classmethod
    def of_layout(cls, layout, stacks) -> "GradShards":
        """From a model's ``sharding.Layout`` (by parameter name), in the
        layout of ``stacking.stack_layers`` over ``stacks``: a stacked
        leaf's spec is its layers' with the layer dim unsplit."""
        shapes = stack_layers({n: torch.empty(s, device="meta") for n, s in layout.shapes.items()},
                              stacks, stack=lambda ts: torch.empty((len(ts),) + tuple(ts[0].shape),
                                                                   device="meta"))
        specs = stack_layers({n: s.spec for n, s in layout.shardings.items()}, stacks,
                             stack=lambda ss: P(None, *ss[0]))
        return cls([tuple(t.shape) for t in T.leaves(shapes)],
                   [NamedSharding(layout.mesh, s) for s in T.leaves(specs)])

    def plan(self, block: int = 1, chunks: int = 1) -> GradPlan:
        """The plan for a wire of ``block``-element blocks over ``chunks``
        chunks of the flat vector."""
        key = (block, chunks)
        if key not in self._plans:
            self._plans[key] = GradPlan(self.shapes, self.shardings, block, chunks)
        return self._plans[key]

    def like(self, tree):
        """The shardings as a tree of ``tree``'s structure (a gradient-shaped
        tree), for ``train.step.gathered`` and ``place``."""
        return T.unflatten(tree, self.shardings)


def whole_tree(chunnels, tree, states, ctx) -> tuple:
    """The transports on the logical gradient, for checks only: the
    gradient and each gradient-shaped state gathered whole, the stack run on
    the full trees, and this rank's blocks of the results cut out. With two
    ranks on each manual axis the step's own-shard path equals it bit for
    bit; with more, the float32 transports' sums (``ring_allreduce``'s, a
    library all-reduce's) add each element in an order set by its place in
    the flat vector, which the rank's view moves, so the two agree up to
    the order of the sum. Its gathers count as ``gather_check``, and its
    transport sends every leaf whole over the manual axes."""
    from repro_torch.comm.chunnels import apply_grad_stack
    from repro_torch.train.step import gathered, place

    shards: GradShards = ctx["shards"]
    n_leaves = len(shards.shapes)

    def grad_shaped(st) -> bool:
        leaves = T.leaves(st)
        return len(leaves) == n_leaves and all(isinstance(x, torch.Tensor) for x in leaves)

    full_states = tuple(gathered(st, shards.like(st), "gather_check") if grad_shaped(st) else st
                        for st in states)
    out, new = apply_grad_stack(chunnels, gathered(tree, shards.like(tree), "gather_check"),
                                full_states, {"mesh": ctx["mesh"]})
    return (place(out, shards.like(out)),
            tuple(place(st, shards.like(st)) if grad_shaped(st) else st for st in new))
