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
- :func:`shard_seq` is the reference's ``shard_activations`` rule for the
  sequence dim of the residual stream (Korthikanti et al.): the rank's
  S/|model| positions where |model| divides S and S >= |model|, else None
  (the residual whole). Decode's one position is never split. The vlm's
  patches take the first P positions of the whole sequence, as the
  reference joins them before the cut: a rank splices in those of its own
  positions (``DenseLM._embed_inputs``). A split residual needs the
  vocabulary split below (:class:`Split` raises without it: no config of
  the zoo lacks it).
- :func:`shard_vocab`: the rank's ``vocab_padded/|model|`` rows of the
  embedding table and columns of the head, where |model| divides
  ``vocab_padded`` (the reference's table spec ``("model", fsdp)`` and head
  ``(fsdp, "model")``).

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

The sequence-parallel residual (``Split.seq``, set for a call of S positions
by :meth:`Split.at`). The residual stream, the layer norms (hymba's fusion
norms too) and the final norm run on the rank's positions, and a
checkpointed layer input is (B_local, S/|model|, D). The "f" becomes the
all-gather of the rank's positions (``collectives.gather_seq``, its backward
a reduce-scatter sum) and the "g" the reduce-scatter of the float32
partials, rounded once (``collectives.scatter_seq``, its backward an
all-gather). A block that stays whole (the attention in serving's sequence
mode or where |model| does not divide H; the SSM where it does not divide
d_in) reads the gathered input (:meth:`Split.gather`) and keeps its output's
own positions (:meth:`Split.own`); the SSM's inner ``x_proj`` sum reads every
position and stays the plain "f"/"g" (:meth:`Split.whole_seq`). Under ``seq``
each rank's loss reads only its own positions, so a parameter it reads whole
(the norms' scales, a whole block's weights) has partial gradients: it is
read as a shared part (its gradient summed over ``model``).

The vocabulary split (``Split.vocab``). The embedding looks up the tokens in
the rank's rows (zeros elsewhere) and sums the ranks' lookups over
``model``: scattered straight into the sequence-parallel residual, or summed
whole (decode, and S that |model| does not divide). The head computes the
rank's columns of the logits from the final norm's output gathered over S
(training: ``layers.vocab_parallel_lm_loss``; serving: the last position's
row, taken from the rank that holds it, and the logits gathered).

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


def shard_seq(S: int, mesh) -> Optional[slice]:
    """This rank's positions of a residual stream of ``S`` positions split
    over ``model``, or None where it stays whole: |model| is 1, does not
    divide S, or exceeds it (the reference's ``shard_activations``)."""
    return shard_model_dim(S, mesh)


def shard_vocab(cfg: ModelConfig, mesh) -> Optional[slice]:
    """This rank's rows of the embedding table (and columns of the head), or
    None where |model| does not divide ``vocab_padded``."""
    return shard_model_dim(cfg.vocab_padded, mesh)


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
SHARED = Read("shared")


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


#: a layer's norms, by their name in the layer (hymba's fusion norms too)
_NORMS = ("ln1", "gn_attn", "gn_ssm", "ln2")
#: the leaves of each block that may stay whole, by their name in the layer
_ATTN = ("attn.wq.w", "attn.wq.b", "attn.wk.w", "attn.wk.b", "attn.wv.w", "attn.wv.b",
         "attn.wo.w")
_MLP = ("mlp.gate.w", "mlp.up.w", "mlp.down.w")
_SSM = tuple(f"ssm.{leaf}" for leaf in ("in_proj.w", "conv_w", "conv_b", "x_proj.w",
                                        "dt_proj.w", "dt_bias", "A_log", "D", "out_proj.w"))


class Split:
    """One rank's compute split over ``model`` of a model of ``cfg``:
    ``heads`` (or None: the attention is whole), ``d_ff`` and ``d_in`` (the
    rank's block of the MLP's and the SSM's channels, or None), ``vocab``
    (the rank's rows of the vocabulary, or None) and ``seq`` (the rank's
    positions of the residual stream in this call, or None: :meth:`at`)."""

    def __init__(self, mesh, cfg: ModelConfig, heads: Optional[Heads],
                 d_ff: Optional[slice], d_in: Optional[slice],
                 vocab: Optional[slice] = None, seq: Optional[slice] = None):
        if seq is not None and vocab is None:
            raise ValueError(f"the sequence-parallel residual needs the vocabulary split: "
                             f"|model| does not divide vocab_padded {cfg.vocab_padded}")
        self.mesh, self.cfg = mesh, cfg
        self.heads, self.d_ff, self.d_in = heads, d_ff, d_in
        self.vocab, self.seq = vocab, seq
        self._reads = self._layer_reads()
        self._top = self._top_reads()

    def _with_seq(self, seq: Optional[slice]) -> "Split":
        if seq == self.seq:
            return self
        return Split(self.mesh, self.cfg, self.heads, self.d_ff, self.d_in, self.vocab, seq)

    def at(self, S: int) -> "Split":
        """This split for a call on ``S`` positions: ``seq`` by
        :func:`shard_seq`."""
        return self._with_seq(shard_seq(S, self.mesh))

    def whole_seq(self) -> "Split":
        """This split with the residual whole (``seq`` None): for a sum inside
        a block that reads every position (the SSM's ``x_proj``)."""
        return self._with_seq(None)

    def enter(self, x: torch.Tensor, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        """``x`` into the column products ("f"): under ``seq`` the all-gather
        of the rank's positions, else the identity; either way the backward
        sums the ranks' cotangents over ``model``. ``dtype`` (float32: the
        vocabulary-split head, whose partial cotangents stay unrounded until
        that sum): the type it enters as."""
        if self.seq is not None:
            return collectives.gather_seq(x, self.mesh, AXIS, dtype)
        return collectives.replicated(x if dtype is None else x.to(dtype), self.mesh, AXIS)

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` into a block computed whole: every position under ``seq``
        (:meth:`enter`'s gather), else ``x`` itself."""
        return self.enter(x) if self.seq is not None else x

    def own(self, x: torch.Tensor) -> torch.Tensor:
        """The rank's positions of a whole block's output (B, S, ...) under
        ``seq`` (its backward pads the cotangent with zeros), else ``x``."""
        if self.seq is None:
            return x
        return x.narrow(1, self.seq.start, self.seq.stop - self.seq.start)

    def reduce(self, *parts: torch.Tensor):
        """The sum over ``model`` of each row product's float32 partial output
        (``Linear.partial``; Megatron's "g"), rounded once to bfloat16: one
        collective for all ``parts`` side by side on their last dim, under
        ``seq`` a reduce-scatter to the rank's positions. One part in, one
        tensor out."""
        x = parts[0] if len(parts) == 1 else torch.cat(parts, dim=-1)
        if self.seq is not None:
            total = collectives.scatter_seq(x, self.mesh, AXIS, COMPUTE)
        else:
            total = collectives.sum_partials(x, self.mesh, AXIS, COMPUTE)
        if len(parts) == 1:
            return total
        return torch.split(total, [p.shape[-1] for p in parts], dim=-1)

    def embed(self, partial: torch.Tensor) -> torch.Tensor:
        """The ranks' vocabulary-parallel lookups (B, S, D) summed over
        ``model`` in bfloat16 (exact: a token's row is on one rank): scattered
        to the rank's positions under ``seq``, else summed whole (its backward
        passes the cotangent on, as the residual is computed alike on every
        rank)."""
        if self.seq is not None:
            return collectives.scatter_seq(partial, self.mesh, AXIS, COMPUTE, op="scatter_embed")
        return collectives.all_reduce_grad(partial, self.mesh, AXIS, downstream="replicated",
                                           op="embed_sum")

    def last_row(self, x: torch.Tensor) -> torch.Tensor:
        """The last position (B, D) of the residual: under ``seq`` from the
        last rank of ``model``, which holds it."""
        if self.seq is None:
            return x[:, -1]
        return collectives.broadcast(x[:, -1], self.mesh, AXIS, self.mesh.shape[AXIS] - 1,
                                     op="last_row")

    def logits(self, local: torch.Tensor) -> torch.Tensor:
        """The rank's columns of the logits (B, vocab_padded/|model|) gathered
        to (B, vocab_padded)."""
        return collectives.gather_dim(local, self.mesh, AXIS, -1, op="gather_logits")

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
        if self.seq is not None:  # read on the rank's positions: partial gradients
            whole = [f"{norm}.{leaf}" for norm in _NORMS for leaf in ("scale", "bias")]
            if self.heads is None:
                whole += _ATTN
            if self.d_ff is None:
                whole += _MLP
            if self.d_in is None and self.cfg.family == "hybrid":
                whole += _SSM
            out.update({n: SHARED for n in whole if n not in out})
        return out

    def _top_reads(self) -> Dict[str, Read]:
        out: Dict[str, Read] = {}
        if self.vocab is not None:
            out["embed.table"] = out["lm_head.w"] = BLOCK
        if self.seq is not None:
            out["final_norm.scale"] = out["final_norm.bias"] = SHARED
        return out

    def reads(self, prefix: Optional[str] = None) -> Dict[str, Read]:
        """The parameters that the split reads otherwise than whole, by their
        name in a layer (``prefix`` None), or in the top-level module
        ``prefix`` (``"embed."``, ``"final_norm."``, ``"lm_head."``)."""
        if prefix is None:
            return self._reads
        return {n[len(prefix):]: r for n, r in self._top.items() if n.startswith(prefix)}

    def read_of(self, name: str) -> Optional[Read]:
        """The read of the model's parameter ``name`` (``layers.{i}.<leaf>``
        or a top-level one), or None (whole)."""
        head, _, rest = name.partition(".")
        if head != "layers":
            return self._top.get(name)
        return self._reads.get(rest.partition(".")[2])

    def __repr__(self) -> str:
        return (f"Split(heads={self.heads}, d_ff={self.d_ff}, d_in={self.d_in}, "
                f"vocab={self.vocab}, seq={self.seq})")


def model_split(cfg: ModelConfig, mesh, kv_mode: Optional[str] = None) -> Optional[Split]:
    """This rank's split of a model of ``cfg`` on ``mesh``, or None where the
    family computes whole (moe, ssm, audio), |model| is 1, or nothing divides.
    ``kv_mode``: the serving KV partition (``"sequence"`` keeps the attention
    whole); None in training. Its ``seq`` is None: a call on S positions
    takes :meth:`Split.at`."""
    if cfg.family not in SPLIT_FAMILIES or mesh is None or _model(mesh)[0] == 1:
        return None
    heads = shard_heads(cfg, mesh, kv_mode)
    d_ff = shard_model_dim(cfg.d_ff, mesh)
    d_in = (shard_model_dim(cfg.ssm.expand * cfg.d_model, mesh)
            if cfg.family == "hybrid" else None)
    vocab = shard_vocab(cfg, mesh)
    if heads is None and d_ff is None and d_in is None and vocab is None:
        return None
    return Split(mesh, cfg, heads, d_ff, d_in, vocab)
