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

:class:`Split` is one rank's split of a model (:func:`model_split`), by
family: dense, vlm and hybrid split the attention's heads, the MLP's d_ff
(the hybrid also the SSM's d_in), the residual over S and the vocabulary.
The moe family splits the heads, the residual and the vocabulary; its
experts are the dispatch's business (``models.moe``), and in training under
a mesh dispatch the split reads the expert banks as the rank's ``model``
block (``experts``). The audio family (the encoder-decoder) splits the
heads of all three attentions (encoder self, decoder self, cross), both
stacks' d_ff, each stack's residual over its own length (the encoder's
split is ``Split.src``, by :meth:`Split.at`) and the vocabulary. In serving
the moe family reads its expert banks as the rank's ``model`` block too
wherever |model| divides E (``experts``, set by ``serving.steps.serve_split``):
every dispatch then runs the rank's experts only. The ssm family (xLSTM)
splits each block by the reference's parameter specs, each by its own
divisibility: the mLSTM by heads (``heads``, where |model| divides H; where
only H·hd divides, the reference's ``wq`` block would cut inside a head, so
the mLSTM stays whole), the sLSTM by channels of D (``channels``; its
diagonal recurrence ``r`` read as its columns of them) and its MLP by its
width ``int(D·4/3)`` (``d_ff``), and the vocabulary. The reference pins its
residual by batch only (``shard_batch``), so ``seq`` is never set. The
mLSTM and the sLSTM share leaf names of unlike shapes (``wi`` is (D, H) in
one, (D, D) in the other), so the reads are by layer kind
(:meth:`Split.reads`' ``layer``). The column products
(``wq``/``wk``/``wv``, ``gate``/``up``, the SSM's ``in_proj``, the xLSTM
gates) take the rank's output block after Megatron's "f" (:meth:`Split.enter`:
the identity, its backward a sum over ``model``); the sLSTM's channels of
its output are all-gathered into the residual (:meth:`Split.join`); its
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

#: the families whose compute splits over ``model``
SPLIT_FAMILIES = ("dense", "vlm", "hybrid", "moe", "audio", "ssm")
#: the families whose residual the reference pins by batch only
#: (``shard_batch``): never sequence-parallel
BATCH_ONLY = ("ssm",)
#: the parameters of the encoder-decoder that the encoder's split reads
#: (``Split.src``), by their first name
SRC_PARAMS = ("encoder", "src_proj", "enc_norm")
#: the stacks of per-layer parameters, by their first name
STACKS = ("layers", "encoder", "decoder")
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


#: a layer's norms, by their name in the layer (hymba's fusion norms, the
#: decoder's cross-attention norm ``lnx`` too)
_NORMS = ("ln1", "gn_attn", "gn_ssm", "lnx", "ln2")
#: a layer's attentions: the decoder-only families' ``attn``, the
#: encoder-decoder's ``attn`` (encoder), ``self_attn`` and ``cross_attn``
_ATTNS = ("attn", "self_attn", "cross_attn")
#: the xLSTM blocks' leaves read as the rank's block: the mLSTM's by heads,
#: the sLSTM's gates by channels, the sLSTM's MLP by its width
_MLSTM = ("wq.w", "wk.w", "wv.w", "wo_gate.w", "wi.w", "wi.b", "wf.w", "wf.b", "wo.w")
_SLSTM = tuple(f"{g}.{leaf}" for g in ("wz", "wi", "wf", "wo_gate") for leaf in ("w", "b"))
_FFN = ("ffn.gate.w", "ffn.up.w", "ffn.down.w")
#: the leaves of each block that may stay whole, by their name in the layer
_ATTN = tuple(f"{a}.{leaf}" for a in _ATTNS
              for leaf in ("wq.w", "wq.b", "wk.w", "wk.b", "wv.w", "wv.b", "wo.w"))
_MLP = ("mlp.gate.w", "mlp.up.w", "mlp.down.w")
#: the moe layer's expert banks and router
_BANKS = ("moe.gate", "moe.up", "moe.down")
_ROUTER = ("moe.router.w",)
_SSM = tuple(f"ssm.{leaf}" for leaf in ("in_proj.w", "conv_w", "conv_b", "x_proj.w",
                                        "dt_proj.w", "dt_bias", "A_log", "D", "out_proj.w"))


class Split:
    """One rank's compute split over ``model`` of a model of ``cfg``:
    ``heads`` (or None: the attention, or xLSTM's mLSTM, is whole), ``d_ff``
    and ``d_in`` (the rank's block of the MLP's and the SSM's channels, or
    None; xLSTM's ``d_ff`` is its sLSTM's MLP), ``vocab`` (the rank's rows
    of the vocabulary, or None), ``seq`` (the rank's positions of the
    residual stream in this call, or None: :meth:`at`), ``experts`` (the moe
    family's expert banks read as the rank's ``model`` block: a training
    call whose dispatch runs on the mesh, and serving wherever |model|
    divides E), ``src`` (the encoder-decoder's split of its encoder in this
    call, whose ``seq`` is the rank's positions of the source, or None) and
    ``channels`` (xLSTM's sLSTM: the rank's block of D, or None)."""

    def __init__(self, mesh, cfg: ModelConfig, heads: Optional[Heads],
                 d_ff: Optional[slice], d_in: Optional[slice],
                 vocab: Optional[slice] = None, seq: Optional[slice] = None,
                 experts: bool = False, src: Optional["Split"] = None,
                 channels: Optional[slice] = None):
        if seq is not None and vocab is None:
            raise ValueError(f"the sequence-parallel residual needs the vocabulary split: "
                             f"|model| does not divide vocab_padded {cfg.vocab_padded}")
        self.mesh, self.cfg = mesh, cfg
        self.heads, self.d_ff, self.d_in, self.channels = heads, d_ff, d_in, channels
        self.vocab, self.seq, self.experts, self.src = vocab, seq, experts, src
        ssm = cfg.family == "ssm"  # xLSTM's reads by layer kind: mLSTM, sLSTM
        self._reads = self._mlstm_reads() if ssm else self._layer_reads()
        self._slstm_reads = self._slstm_layer_reads() if ssm else {}
        self._top = self._top_reads()

    def _with(self, **kw) -> "Split":
        fields = {"seq": self.seq, "experts": self.experts, "src": self.src, **kw}
        if all(fields[k] is getattr(self, k) or fields[k] == getattr(self, k) for k in fields):
            return self
        return Split(self.mesh, self.cfg, self.heads, self.d_ff, self.d_in, self.vocab,
                     channels=self.channels, **fields)

    def at(self, S: int, S_src: Optional[int] = None) -> "Split":
        """This split for a call on ``S`` positions: ``seq`` by
        :func:`shard_seq` (None for the families the reference pins by
        batch only); ``S_src``, the encoder-decoder's source positions, gives
        ``src``, the encoder's split of them."""
        seq = None if self.cfg.family in BATCH_ONLY else shard_seq(S, self.mesh)
        src = None if S_src is None else self._with(src=None).at(S_src)
        return self._with(seq=seq, src=src)

    def whole_seq(self) -> "Split":
        """This split with the residual whole (``seq`` None): for a sum inside
        a block that reads every position (the SSM's ``x_proj``)."""
        return self._with(seq=None)

    def with_experts(self) -> "Split":
        """This split reading the expert banks as the rank's ``model`` block:
        the moe family's training call whose dispatch runs on the mesh
        (``models.moe.mesh_dispatch``), and its serving wherever |model|
        divides E."""
        return self._with(experts=True)

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

    def join(self, x: torch.Tensor) -> torch.Tensor:
        """The rank's channels (B, S, D/|model|) of a block split by channels
        (xLSTM's sLSTM) all-gathered over ``model`` into (B, S, D), for the
        residual (``gather_channels``). Every rank repeats the residual's
        computation on it, so the backward is the rank's own block of the
        cotangent, with no sum."""
        return collectives.gather_grad(x, self.mesh, AXIS, -1, downstream="replicated",
                                       op="gather_channels")

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
            kv = self.heads.kv
            read = BLOCK if self.heads.kv_block else _narrow(-1, slice(kv.start * hd,
                                                                       kv.stop * hd))
            for a in _ATTNS:
                for leaf in ("wq.w", "wq.b", "wo.w"):
                    out[f"{a}.{leaf}"] = BLOCK
                for leaf in ("wk.w", "wk.b", "wv.w", "wv.b"):
                    out[f"{a}.{leaf}"] = read
        if self.d_ff is not None:
            for leaf in _MLP:
                out[leaf] = BLOCK
        if self.experts:
            for leaf in _BANKS:
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
            if self.cfg.family == "moe" and not self.experts:
                # the dispatch on the rows gathered over S: each rank's loss
                # reads its own positions of it. Under a mesh dispatch the
                # router enters through ``moe._router``, whose backward sums
                # it over ``model`` already
                whole += _ROUTER + _BANKS
            out.update({n: SHARED for n in whole if n not in out})
        return out

    def _mlstm_reads(self) -> Dict[str, Read]:
        """xLSTM's mLSTM layer: the rank's heads of every product."""
        return {leaf: BLOCK for leaf in _MLSTM} if self.heads is not None else {}

    def _slstm_layer_reads(self) -> Dict[str, Read]:
        """xLSTM's sLSTM layer: its gates' and ``r``'s channels (``r`` is
        replicated in the layout: its columns of the whole, a part whose
        gradient is summed over ``model``), its MLP's block."""
        out: Dict[str, Read] = {}
        if self.channels is not None:
            out.update({leaf: BLOCK for leaf in _SLSTM})
            out["r"] = _narrow(-1, self.channels)
        if self.d_ff is not None:
            out.update({leaf: BLOCK for leaf in _FFN})
        return out

    def _top_reads(self) -> Dict[str, Read]:
        out: Dict[str, Read] = {}
        if self.vocab is not None:
            out["embed.table"] = out["lm_head.w"] = BLOCK
        if self.seq is not None:  # read on the rank's positions
            for name in ("final_norm.scale", "final_norm.bias", "enc_norm.scale",
                         "enc_norm.bias", "src_proj.w", "src_proj.b"):
                out[name] = SHARED
        return out

    def is_slstm(self, layer: int) -> bool:
        """Whether layer ``layer`` is an sLSTM block (xLSTM's layers differ)."""
        if self.cfg.family != "ssm":
            return False
        # imported here: models.xlstm imports this module
        from repro_torch.models.xlstm import is_slstm

        return is_slstm(layer, self.cfg)

    def reads(self, prefix: Optional[str] = None, *, layer: int = 0) -> Dict[str, Read]:
        """The parameters that the split reads otherwise than whole, by their
        name in a layer (``prefix`` None; xLSTM's by the kind of layer
        ``layer``), or in the top-level module ``prefix`` (``"embed."``,
        ``"final_norm."``, ``"lm_head."``; the encoder-decoder's
        ``"src_proj."`` and ``"enc_norm."`` by ``src``)."""
        if prefix is None:
            return self._slstm_reads if self.is_slstm(layer) else self._reads
        if self.src is not None and prefix.partition(".")[0] in SRC_PARAMS:
            return self.src.reads(prefix)
        return {n[len(prefix):]: r for n, r in self._top.items() if n.startswith(prefix)}

    def read_of(self, name: str) -> Optional[Read]:
        """The read of the model's parameter ``name`` (``layers.{i}.<leaf>``,
        ``encoder.{i}.<leaf>``, ``decoder.{i}.<leaf>`` or a top-level one),
        or None (whole). The encoder's parameters are read by ``src`` where
        it is set."""
        head, _, rest = name.partition(".")
        if self.src is not None and head in SRC_PARAMS:
            return self.src.read_of(name)
        if head not in STACKS:
            return self._top.get(name)
        idx, _, leaf = rest.partition(".")
        return self.reads(layer=int(idx)).get(leaf)

    def __repr__(self) -> str:
        extra = (", experts=True" if self.experts else "") + \
            (f", src_seq={self.src.seq}" if self.src is not None else "") + \
            (f", channels={self.channels}" if self.channels is not None else "")
        return (f"Split(heads={self.heads}, d_ff={self.d_ff}, d_in={self.d_in}, "
                f"vocab={self.vocab}, seq={self.seq}{extra})")


def slstm_width(cfg: ModelConfig) -> int:
    """The width of xLSTM's sLSTM MLP (the reference's ``f_up``; its config's
    ``d_ff`` is 0)."""
    return int(cfg.d_model * 4 / 3)


def _mlstm_heads(cfg: ModelConfig, mesh) -> Optional[Heads]:
    """The rank's mLSTM heads (its q, k and v alike), where |model| divides
    H; else None (the reference's ``wq`` block would cut inside a head where
    only H·hd divides)."""
    m, r = _model(mesh)
    if cfg.num_heads % m:
        return None
    hl = cfg.num_heads // m
    return Heads(slice(r * hl, (r + 1) * hl), slice(r * hl, (r + 1) * hl), True)


def model_split(cfg: ModelConfig, mesh, kv_mode: Optional[str] = None) -> Optional[Split]:
    """This rank's split of a model of ``cfg`` on ``mesh``, or None where
    |model| is 1 or nothing divides. By family: heads, d_ff and vocabulary
    (dense, vlm, audio), with d_in (hybrid); heads and vocabulary (moe: its
    config's ``d_ff`` names no dense MLP); the mLSTM's heads, the sLSTM's
    channels and MLP width, and the vocabulary (ssm). ``kv_mode``: the
    serving KV partition (``"sequence"`` keeps the attention whole); None in
    training. Its ``seq`` is None: a call on S positions takes
    :meth:`Split.at`."""
    if cfg.family not in SPLIT_FAMILIES or mesh is None or _model(mesh)[0] == 1:
        return None
    ssm = cfg.family == "ssm"
    heads = _mlstm_heads(cfg, mesh) if ssm else shard_heads(cfg, mesh, kv_mode)
    d_ff = (shard_model_dim(slstm_width(cfg) if ssm else cfg.d_ff, mesh)
            if cfg.family in ("dense", "vlm", "hybrid", "audio", "ssm") else None)
    d_in = (shard_model_dim(cfg.ssm.expand * cfg.d_model, mesh)
            if cfg.family == "hybrid" else None)
    channels = shard_model_dim(cfg.d_model, mesh) if ssm else None
    vocab = shard_vocab(cfg, mesh)
    if heads is None and d_ff is None and d_in is None and vocab is None and channels is None:
        return None
    return Split(mesh, cfg, heads, d_ff, d_in, vocab, channels=channels)
