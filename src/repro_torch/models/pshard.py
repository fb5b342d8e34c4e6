"""The compute split over ``model``: which block of the work a rank does.

The counterpart of ``src/repro/models/pshard.py``. The reference pins
activation layouts (``with_sharding_constraint``) and leaves XLA's
partitioner to split the compute by them and by the parameters' specs
(``models/sharding.py``: the column products' outputs over ``model``, the
row products' inputs over ``model``). The port has no partitioner: each rank
is a process, so it computes its own block, and this module says which, by
the reference's divisibility rules:

- :func:`shard_heads` is the reference's ``shard_heads`` rule: the query
  heads over ``model`` where |model| divides H, the KV heads where it divides
  KH (else every rank reads them whole). A rank computes query heads
  ``[r·H/m, (r+1)·H/m)`` and the KV heads they read (GQA: head h reads KV
  head h // (H/KH)).
- :func:`shard_model_dim` is the reference's ``shard_model_dim`` rule: a
  dim over ``model`` where |model| divides it (the SSM's ``d_in`` channels;
  the port applies it to the MLP's ``d_ff`` too, which the reference's
  partitioner splits by the ``gate``/``up``/``down`` specs).
- ``shard_batch`` has its counterpart already: a rank's rows of the batch
  are ``train.step.local_rows`` in training and ``ServeSteps.rows`` in
  serving.
- ``shard_activations`` (the sequence-parallel residual) is not ported yet.

:class:`Split` is one rank's split of a model of the dense, vlm or hybrid
family (:func:`model_split`; the other families compute whole on every rank
of ``model``). Its column products (``wq``/``wk``/``wv``, ``gate``/``up``,
the SSM's ``in_proj``) take the rank's output block after Megatron's "f"
(:meth:`Split.enter`: the identity, its backward a sum over ``model``); its
row products (``wo``, ``down``, ``out_proj``, and ``x_proj``, whose input is
the rank's channels) take the rank's input block, and their partial outputs
are summed by the "g" (:meth:`Split.reduce`: a float32 sum of the bfloat16
partials, rounded once; its backward the identity). :meth:`Split.reads`
says how each parameter of a layer is read from its layout block
(``sharding.Layout.read``): its own ``model`` block (gathered over the batch
axes only), a part of the whole that the ranks of ``model`` each take
apart (gathered over every axis, its backward a sum over ``model``), or
whole.

Where the attention stays whole. In serving, sequence mode
(``comm.kvshard``) holds every head of its positions, so the attention block
is computed whole on every rank, and only the MLP (and the SSM) splits. In
training, the attention stays whole where |model| does not divide H
(hymba-1.5b's 25 heads), or where KV heads would be read by unequal shares
of a rank's query heads (|model| neither divides KH nor is divided by it;
no config of the zoo).
"""
from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional

import torch

from repro_torch.comm import collectives
from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import COMPUTE

#: the families whose layers split their compute over ``model``
SPLIT_FAMILIES = ("dense", "vlm", "hybrid")
AXIS = "model"


def _model(mesh) -> tuple:
    """(|model|, this rank's index along it)."""
    if AXIS not in mesh.axis_names:
        return 1, 0
    return mesh.shape[AXIS], mesh.coords.get(AXIS, 0)


def shard_model_dim(n: int, mesh) -> Optional[slice]:
    """This rank's block of a dim of ``n`` channels split over ``model``, or
    None where it is whole: |model| is 1 or does not divide ``n`` (the
    reference's ``shard_model_dim``)."""
    m, r = _model(mesh)
    if m == 1 or n % m or n < m:
        return None
    per = n // m
    return slice(r * per, (r + 1) * per)


class Heads(NamedTuple):
    """A rank's heads: its query heads, the KV heads they read, and whether
    those are its block of ``wk``/``wv`` (|model| divides KH), or a part of
    the whole that other ranks read too."""
    q: slice
    kv: slice
    kv_block: bool


def shard_heads(cfg: ModelConfig, mesh, kv_mode: Optional[str] = None) -> Optional[Heads]:
    """The rank's heads, or None where the attention is computed whole on
    every rank of ``model``: |model| is 1 or does not divide H, a serving
    ``kv_mode`` of ``"sequence"`` (the cache holds every head), or KV heads
    that the rank's query heads would read in unequal shares."""
    m, r = _model(mesh)
    H, KH = cfg.num_heads, cfg.num_kv_heads
    if m == 1 or H % m or kv_mode == "sequence":
        return None
    hl = H // m
    q = slice(r * hl, (r + 1) * hl)
    if KH % m == 0:
        kl = KH // m
        return Heads(q, slice(r * kl, (r + 1) * kl), True)
    if m % KH:
        return None
    kv = r * hl // (H // KH)  # |model| / KH ranks share each KV head
    return Heads(q, slice(kv, kv + 1), False)


class Read(NamedTuple):
    """How a split layer reads a parameter from its layout block: ``"block"``
    (its ``model`` block, gathered over the batch axes) or ``"shared"`` (the
    whole tensor, of which ``take`` gives the rank's part)."""
    how: str
    take: Optional[Callable[[torch.Tensor], torch.Tensor]] = None


BLOCK = Read("block")


def _narrow(dim: int, block: slice) -> Read:
    return Read("shared", lambda t: t.narrow(dim, block.start, block.stop - block.start))


def _halves(d_in: int, block: slice) -> Read:
    """``in_proj``'s rank part: its channels of x and of the gate z. The
    layout cuts the fused (D, 2·d_in) output into contiguous blocks, which
    on |model| 2 are all of x on rank 0 and all of z on rank 1."""
    n = block.stop - block.start

    def take(t):
        return torch.cat([t.narrow(-1, block.start, n), t.narrow(-1, d_in + block.start, n)],
                         dim=-1)

    return Read("shared", take)


class Split:
    """One rank's compute split over ``model`` of a model of ``cfg``:
    ``heads`` (or None: the attention is whole), ``d_ff`` and ``d_in`` (the
    rank's block of the MLP's and the SSM's channels, or None)."""

    def __init__(self, mesh, cfg: ModelConfig, heads: Optional[Heads],
                 d_ff: Optional[slice], d_in: Optional[slice]):
        self.mesh, self.cfg = mesh, cfg
        self.heads, self.d_ff, self.d_in = heads, d_ff, d_in
        self._reads = self._layer_reads()

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` into the column products ("f"): the identity, its backward
        the sum over ``model`` of the ranks' cotangents."""
        return collectives.replicated(x, self.mesh, AXIS)

    def reduce(self, *parts: torch.Tensor):
        """The sum over ``model`` of each row product's float32 partial output
        (``Linear.partial``; Megatron's "g"), rounded once to bfloat16: one
        collective for all ``parts`` side by side on their last dim. One part
        in, one tensor out."""
        if len(parts) == 1:
            return collectives.sum_partials(parts[0], self.mesh, AXIS, COMPUTE)
        total = collectives.sum_partials(torch.cat(parts, dim=-1), self.mesh, AXIS, COMPUTE)
        return torch.split(total, [p.shape[-1] for p in parts], dim=-1)

    def _layer_reads(self) -> Dict[str, Read]:
        out: Dict[str, Read] = {}
        hd = self.cfg.head_dim_
        if self.heads is not None:
            for leaf in ("attn.wq.w", "attn.wq.b", "attn.wo.w"):
                out[leaf] = BLOCK
            kv = self.heads.kv
            read = BLOCK if self.heads.kv_block else _narrow(-1, slice(kv.start * hd,
                                                                       kv.stop * hd))
            for leaf in ("attn.wk.w", "attn.wk.b", "attn.wv.w", "attn.wv.b"):
                out[leaf] = read
        if self.d_ff is not None:
            for leaf in ("mlp.gate.w", "mlp.up.w", "mlp.down.w"):
                out[leaf] = BLOCK
        if self.d_in is not None:
            d_in = self.cfg.ssm.expand * self.cfg.d_model
            for leaf in ("conv_w", "dt_proj.w", "A_log", "out_proj.w"):
                out[f"ssm.{leaf}"] = BLOCK
            for leaf in ("conv_b", "dt_bias", "D"):
                out[f"ssm.{leaf}"] = _narrow(-1, self.d_in)
            out["ssm.in_proj.w"] = _halves(d_in, self.d_in)
            out["ssm.x_proj.w"] = _narrow(0, self.d_in)
        return out

    def reads(self) -> Dict[str, Read]:
        """A layer's parameters that the split reads otherwise than whole, by
        their name in the layer."""
        return self._reads

    def read_of(self, name: str) -> Optional[Read]:
        """The read of the model's parameter ``name`` (``layers.{i}.<leaf>``),
        or None (whole)."""
        head, _, rest = name.partition(".")
        if head != "layers":
            return None
        return self._reads.get(rest.partition(".")[2])

    def __repr__(self) -> str:
        return f"Split(heads={self.heads}, d_ff={self.d_ff}, d_in={self.d_in})"


def model_split(cfg: ModelConfig, mesh, kv_mode: Optional[str] = None) -> Optional[Split]:
    """This rank's split of a model of ``cfg`` on ``mesh``, or None where the
    family computes whole (moe, ssm, audio), |model| is 1, or nothing divides.
    ``kv_mode``: the serving KV partition (``"sequence"`` keeps the attention
    whole); None in training."""
    if cfg.family not in SPLIT_FAMILIES or mesh is None or _model(mesh)[0] == 1:
        return None
    heads = shard_heads(cfg, mesh, kv_mode)
    d_ff = shard_model_dim(cfg.d_ff, mesh)
    d_in = (shard_model_dim(cfg.ssm.expand * cfg.d_model, mesh)
            if cfg.family == "hybrid" else None)
    if heads is None and d_ff is None and d_in is None:
        return None
    return Split(mesh, cfg, heads, d_ff, d_in)
