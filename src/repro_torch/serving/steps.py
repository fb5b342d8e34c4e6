"""Serve steps on a mesh: prefill and decode with the reference's shardings.

The counterpart of ``src/repro/serving/steps.py``. The reference jits its
model's prefill and decode with ``NamedSharding``s and leaves the compute's
split to the partitioner; here every rank of a ``launch.mesh.Mesh`` is a
process of its own and the split is explicit:

- Parameters are laid out by ``registry.param_specs`` (``lay_out``): the
  model keeps this rank's ``Layout`` block of every parameter. The forward
  reads working copies made once from the blocks: the bfloat16 serving
  copies of the matrices (``prepare``) and a float32 copy of each leaf the
  forward reads in float32 (the SSM's conv and ``A_log``, xLSTM's gates,
  the MoE router). Every family splits its compute over ``model``
  (``models.pshard``, for the steps' KV mode; xLSTM's mLSTM by heads, its
  sLSTM by channels): the working copy of a leaf the split consumes is the
  rank's part of it (its ``model`` block gathered over the batch axes
  only; ``in_proj``'s channels of x and z, ``x_proj``'s input rows and the
  sLSTM's ``r`` columns cut from the gathered whole), so a rank holds about
  1/|model| of those layers' weights; where |model| divides
  ``vocab_padded`` the table's and the head's copies are the rank's rows
  and columns of the vocabulary (the tied llama table halves on |model|
  2). Where |model| divides E the MoE banks' copies are the rank's
  ``E/|model|`` experts (:func:`serve_split` sets ``Split.experts``): the
  mesh dispatches run them as they are and ``grouped`` runs
  expert-parallel, its float32 partials summed over ``model``
  (``models.moe.dispatch_grouped_ep``). Every other leaf's copy is
  gathered whole.
- Batch rows go by ``data_spec``: each rank runs the forward on its rows of
  the global batch (all of them where the batch does not divide the batch
  axes); the ranks along ``model`` share their rows, and under the split
  each computes its heads and channels and sums the row products over
  ``model`` (in a prefill whose S |model| divides, on the rank's positions
  of a sequence-parallel residual, ``models.pshard``; the last position's
  row comes from the last rank of ``model``). Prefill runs the model's prefill on the rows (its attention
  through the model's ``attn_impl``, the flash kernel on the card, on the
  rank's heads under the split), then cuts the cache to this rank's slices
  (a split model's K/V heads and SSM channels are its slices already).
- Caches are laid out by :func:`cache_shardings` (the reference's rules,
  leaf for leaf), at the capacity of a decode ``ShapeConfig`` (the
  reference's ``Model.cache_specs(shape)``); between steps every cache leaf
  is its spec's local slice.
- Decode goes through the negotiated KV-partition chunnel
  (``comm.kvshard.pick_kv_chunnel``), passed to the model's decode slot at
  every step (the model keeps no step's state but its mesh and split).
  Heads mode: a rank holds KV heads ``[r·KH/m, (r+1)·KH/m)``; a split model
  (every family with KV heads) computes those heads of the new K/V and the
  query heads they serve, and its ``wo`` sums the output over ``model``.
  The slot's all-gather of every head's output serves a model that
  computes every head, which no family of the zoo does any more.
  Sequence mode: the rank that owns position ``pos`` writes it, and
  attention is the flash-decode combine over ``model`` (a split model's
  attention block is whole there, ``comm.kvshard``'s hazard); the cache's
  capacity must divide by ``|model|`` (the reference's ``cache_spec_for``
  replicates the sequence otherwise, and its ``shard_map`` could not run),
  and :class:`ServeSteps` raises otherwise. The hybrid's rings are attended
  by the same partition (``HymbaLM.decode_step``'s ``ring_fn``): by heads,
  or by slots with the combine.
- A split model's cache leaves stay its slices between steps
  (:func:`kept_slice`): its K/V, the SSM state of its channels (``ssm_h``,
  ``ssm_conv``), xLSTM's state of its heads (the mLSTM's ``C``, ``n``) and
  channels (the sLSTM's ``c``, ``n``, ``h``), and in heads mode the
  encoder-decoder's cross caches (``xk``, ``xv``: the rank's KV heads,
  computed as such by its prefill). The reference's spec cuts the mLSTM's
  ``C`` and ``n`` on ``hd``; a split by ``hd`` would need a collective in
  every chunk (``q·k`` and ``C·q`` contract over it), so :class:`ServeSteps`
  lays them out by the split's heads (:func:`state_shardings`) while
  :func:`cache_shardings` stays the reference's. The leaves that the model
  reads whole over ``model`` and whose spec splits them are gathered over
  ``model`` for the step and cut to the slice after (``gather_cache``): a
  whole xLSTM block's state (|model| does not divide its heads or
  channels), and in sequence mode the cross caches (split by source
  position there, while the cross attention reads every position of
  them).

``serve_rank`` and ``serve_sharded`` serve one arch on a spawned mesh
(``launch.mesh.spawn``): the serve launcher's ``--world``. Entry points take
``device=`` (``"cuda"`` by default, which raises without a GPU).
"""
from __future__ import annotations

import math
import time
from typing import Any, Optional

import torch
import torch.distributed as dist

from repro_torch import tree as T
from repro_torch.comm import collectives
from repro_torch.comm.kvshard import pick_kv_chunnel
from repro_torch.configs.base import ModelConfig, ShapeConfig, ShardingConfig
from repro_torch.launch.mesh import BATCH_AXES
from repro_torch.models import registry
from repro_torch.models.pshard import Split, model_split
from repro_torch.models.sharding import (
    P,
    Layout,
    NamedSharding,
    batch_axes,
    cache_spec_for,
    kv_partition_mode,
    per_layer,
)

#: the cache leaves of K/V behind the decode slot, of the encoder-decoder's
#: cross attention, and of the SSM state, by name
KV_LEAVES = ("k", "v")
CROSS_LEAVES = ("xk", "xv")
SSM_LEAVES = ("ssm_h", "ssm_conv")


def _xlstm_slice(split: Optional[Split], path) -> bool:
    """Whether a split xLSTM computes the state leaf at ``path``
    (``("layers", i, leaf)``) as its slice: an mLSTM's under a heads split,
    an sLSTM's under a channels split."""
    if split is None:
        return False
    if split.is_slstm(int(path[1])):
        return split.channels is not None
    return split.heads is not None


def computed_slice(split: Optional[Split], path) -> bool:
    """Whether a model under ``split`` computes the cache leaf at ``path``
    as its slice: its KV heads (self and cross) under a heads split, its
    SSM channels under a d_in split, xLSTM's state of its heads or
    channels."""
    if split is None:
        return False
    if split.cfg.family == "ssm":
        return _xlstm_slice(split, path)
    return ((path[-1] in KV_LEAVES + CROSS_LEAVES and split.heads is not None)
            or (path[-1] in SSM_LEAVES and split.d_in is not None))


def kept_slice(cfg: ModelConfig, split: Optional[Split], path, behind_slot: bool) -> bool:
    """Whether the cache leaf at ``path`` stays the rank's slice between
    decode steps (no ``gather_cache``): a K/V leaf behind the decode slot
    (``behind_slot``), xLSTM's state where its block is split, and every
    leaf of another split model but the cross caches it does not compute as
    slices (sequence mode)."""
    if cfg.family == "ssm":
        return _xlstm_slice(split, path)
    if path[-1] in KV_LEAVES and behind_slot:
        return True
    return split is not None and (path[-1] not in CROSS_LEAVES or computed_slice(split, path))


def cache_shardings(cache: Any, cfg: ModelConfig, mesh, sh: ShardingConfig):
    """A tree of :class:`P` of ``cache``'s structure (leaves with a
    ``.shape``, and ``"len"``): the reference's per-leaf rules. K/V leaves
    (``k``, ``v``, ``xk``, ``xv``) by ``cache_spec_for``; the SSM state, the
    mLSTM ``C``/``n`` and the sLSTM's 2-D leaves over ``model`` on their
    channel dim where it divides, their batch dim over the batch axes where
    that divides; anything else replicated."""
    axes = batch_axes(mesh)
    b_ax = axes if len(axes) > 1 else (axes[0] if axes else None)
    n_batch = math.prod(mesh.shape[a] for a in axes)
    m = mesh.shape.get("model", 1)

    def spec(path, leaf) -> P:
        leafname = str(path[-1]) if path else ""
        shape = tuple(getattr(leaf, "shape", ()))
        if leafname in ("k", "v", "xk", "xv") and len(shape) >= 4:
            return cache_spec_for(shape, cfg, mesh, sh)
        bspec = b_ax if (len(shape) >= 2 and shape[0] % max(n_batch, 1) == 0) else None
        if leafname == "ssm_h":  # (B, d_in, N)
            return P(bspec, "model" if shape[1] % m == 0 else None, None)
        if leafname == "ssm_conv":  # (B, K-1, d_in)
            return P(bspec, None, "model" if shape[2] % m == 0 else None)
        if leafname == "C" and len(shape) == 4:  # mLSTM (B,H,hd,hd)
            return P(bspec, None, "model" if shape[2] % m == 0 else None, None)
        if leafname == "n" and len(shape) == 3:  # (B,H,hd)
            return P(bspec, None, "model" if shape[2] % m == 0 else None)
        if len(shape) == 2:  # sLSTM c/n/h (B,D)
            return P(bspec, "model" if shape[1] % m == 0 else None)
        return P()

    pairs = T.flatten_with_paths(cache)
    return T.unflatten(cache, [spec(path, leaf) for path, leaf in pairs])


def state_shardings(specs: Any, split: Optional[Split]):
    """``specs`` (:func:`cache_shardings`' tree) with a split mLSTM's ``C``
    and ``n`` laid out by the split's heads (dim 1) in place of the
    reference's ``hd`` (dim 2): the port computes a rank's heads, whose
    state holds every ``hd`` of them. Any other leaf as it is."""
    if split is None or split.cfg.family != "ssm" or split.heads is None:
        return specs

    def by_heads(path, spec: P) -> P:
        if len(path) != 3 or path[0] != "layers" or split.is_slstm(int(path[1])):
            return spec
        return P(spec[0], "model", *([None] * (len(spec) - 2)))

    return T.unflatten(specs, [by_heads(path, s) for path, s in T.flatten_with_paths(specs)])


# ---------------------------------------------------------------------------
# Parameters: blocks and working copies
# ---------------------------------------------------------------------------


def _layout(model, mesh, sh: ShardingConfig) -> Layout:
    specs = per_layer(registry.param_specs(model, sh, mesh), model.stacks())
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    return Layout(mesh, specs, shapes)


def serve_split(cfg: ModelConfig, mesh, sh: ShardingConfig) -> Optional[Split]:
    """The compute split of a model of ``cfg`` served on ``mesh`` in the KV
    mode that ``sh`` gives (sequence mode keeps the attention whole),
    reading the MoE banks as the rank's experts wherever |model| divides E
    (but for the ``dense`` dispatch, which reads every expert)."""
    mode = kv_partition_mode(cfg, mesh, sh) if cfg.family != "ssm" else None
    split = model_split(cfg, mesh, mode)
    if (split is not None and cfg.moe is not None and cfg.moe.dispatch != "dense"
            and cfg.moe.num_experts % mesh.shape["model"] == 0):
        split = split.with_experts()
    return split


def _same_split(a: Optional[Split], b: Optional[Split]) -> bool:
    key = lambda s: None if s is None else (  # noqa: E731
        s.heads, s.d_ff, s.d_in, s.vocab, s.channels, s.experts)
    return key(a) == key(b)


@torch.no_grad()
def lay_out(model, mesh, sh: ShardingConfig, split: Optional[Split] = None) -> Layout:
    """Keep this rank's block of every parameter of ``model`` by the
    reference's ``param_specs`` (unless it holds its blocks already:
    ``build_sharded``), and make the forward's working copies from the
    blocks: bfloat16 serving copies gathered in bfloat16, and a float32
    copy of each split parameter the forward reads in float32 (every split
    parameter of a module with no serving copies, and a ``Linear`` with
    ``reads_f32``), which takes the block's place in the module. A leaf the
    compute ``split`` consumes is read as the split reads it
    (``Layout.read``): the rank's part, not the whole. The blocks stay in
    ``model.blocks``; a model laid out before is laid out again from them.
    Sets ``model.split``. Returns the layout."""
    if model.layout is None:
        model.release()
        model.shard(_layout(model, mesh, sh))
    layout = model.layout
    if getattr(model, "blocks", None) is not None:  # back to the blocks
        for name, block in model.blocks.items():
            mod_name, _, pn = name.rpartition(".")
            model.get_submodule(mod_name)._parameters[pn] = block
    model.blocks = dict(model.named_parameters())
    read_of = split.read_of if split is not None else (lambda name: None)
    for mod_name, mod in model.named_modules():
        if mod is model:
            continue
        prefix = f"{mod_name}." if mod_name else ""
        reads = {pn: read_of(prefix + pn) for pn in mod._parameters}
        names = [pn for pn, p in mod._parameters.items()
                 if p is not None and (layout.splits.get(prefix + pn) or reads[pn])]
        if hasattr(mod, "prepare"):
            blocks = dict(mod._parameters)
            for pn in names:
                mod._parameters[pn] = layout.read(prefix + pn,
                                                  blocks[pn].detach().to(torch.bfloat16),
                                                  reads[pn])
            mod.prepare()
            mod._parameters.update(blocks)
            if not getattr(mod, "reads_f32", False):
                continue
        for pn in names:
            work = layout.read(prefix + pn, mod._parameters[pn].detach(), reads[pn])
            mod._parameters[pn] = torch.nn.Parameter(work.contiguous(), requires_grad=False)
    model.split = split
    return layout


def build_sharded(cfg: ModelConfig, mesh, sh: ShardingConfig, *, seed: int = 0):
    """The model of ``cfg`` drawn from ``seed`` on the mesh's device,
    holding this rank's ``Layout`` blocks; :class:`ServeSteps` makes its
    working copies and sets its decode slot. The ranks draw in turn, each
    keeping only its blocks before the next draws, so that ranks that share
    a card never hold more than one full model at once."""
    model = None
    for r in range(mesh.size):
        if mesh.rank == r:
            model = registry.build(cfg, device=mesh.device, seed=seed, mesh=mesh)
            model.shard(_layout(model, mesh, sh))
        if mesh.size > 1:
            dist.barrier()
    return model


# ---------------------------------------------------------------------------
# The steps
# ---------------------------------------------------------------------------


def _own(x, sharding: NamedSharding):
    """The slice of a rank's rows that this rank keeps: its block of every
    dim split over an axis other than the batch axes (its rows are its
    block of those already)."""
    if not torch.is_tensor(x):
        return x
    for dim, axis in sharding.splits(x.dim()):
        if axis not in BATCH_AXES:
            per = x.shape[dim] // sharding.mesh.shape[axis]
            x = x.narrow(dim, sharding.mesh.coords[axis] * per, per)
    return x.contiguous()


def _lift(x, sharding: NamedSharding):
    """The rank's rows of a leaf whole in every other dim: its blocks
    gathered over every axis but the batch axes."""
    if not torch.is_tensor(x):
        return x
    for dim, axis in reversed(sharding.splits(x.dim())):
        if axis not in BATCH_AXES:
            x = collectives.gather_dim(x, sharding.mesh, axis, dim, op="gather_cache")
    return x


def fit_cache(cache: Any, like: Any) -> Any:
    """``cache`` (a prefill's) with each tensor leaf zero-padded at the end
    of every dim to ``like``'s shape (a cache of the capacity to decode
    into; ``registry.cache_shapes``): the K/V positions, the cross caches'
    rows. A ring of fewer slots than its window holds its positions at
    their own slots, so it pads the same way. ``"len"`` stays."""
    def fit(x, ref):
        if not torch.is_tensor(x):
            return x
        want = tuple(ref.shape)
        if len(want) != x.dim() or any(w < s for w, s in zip(want, x.shape)):
            raise ValueError(f"a cache leaf of {tuple(x.shape)} does not fit {want}")
        pad = []
        for w, s in reversed(list(zip(want, x.shape))):
            pad += [0, w - s]
        return torch.nn.functional.pad(x, pad) if any(pad) else x

    return T.map(fit, cache, like)


class ServeSteps:
    """Prefill and decode of ``model`` on this rank of ``mesh``, for a
    decode ``shape`` (its ``global_batch`` rows, its ``seq_len`` the cache's
    capacity). ``model`` is built for the mesh (``build_sharded``, or
    ``registry.build(..., mesh=mesh)``); its parameters are laid out here
    (``lay_out``) unless they already are."""

    def __init__(self, model, mesh, sh: ShardingConfig, shape: ShapeConfig):
        cfg = model.cfg
        self.model, self.mesh, self.shape = model, mesh, shape
        m = mesh.shape.get("model", 1)
        has_kv = cfg.family != "ssm"
        self.mode = kv_partition_mode(cfg, mesh, sh) if has_kv else None
        if self.mode == "sequence" and shape.seq_len % m:
            raise ValueError(
                f"sequence-sharded KV: a capacity of {shape.seq_len} positions does not split "
                f"over model ({m}); the reference's cache_spec_for would replicate it and its "
                "shard_map could not run. Choose a capacity that |model| divides")
        if self.mode == "heads" and cfg.num_kv_heads % m:
            raise ValueError(f"head-sharded KV: {cfg.num_kv_heads} KV heads do not split over "
                             f"model ({m}); use kv_partition 'sequence' or 'auto'")
        self.kv = pick_kv_chunnel(cfg, mesh, sh) if has_kv else None
        n_rows = math.prod(mesh.shape[a] for a in batch_axes(mesh))
        self.dealt = shape.global_batch % n_rows == 0
        self.rows_per_rank = shape.global_batch // n_rows if self.dealt else shape.global_batch
        self.split = serve_split(cfg, mesh, sh)
        if getattr(model, "blocks", None) is None or not _same_split(model.split, self.split):
            lay_out(model, mesh, sh, self.split)  # once for each split the steps take
        model.mesh = mesh
        heads = self.split is not None and self.split.heads is not None
        global_shapes = registry.cache_shapes(cfg, shape)
        self.cache_sh = T.map(lambda s: NamedSharding(mesh, s), state_shardings(
            cache_shardings(global_shapes, cfg, mesh, sh), self.split))
        paths = [path for path, leaf in T.flatten_with_paths(global_shapes) if torch.is_tensor(leaf)]
        # the leaves the split model computes as its slices, and those that
        # stay its slices between steps
        self._computed = {p for p in paths if computed_slice(self.split, p)}
        self._kept = {p for p in paths if kept_slice(
            cfg, self.split, p, p[-1] in KV_LEAVES and self._behind_slot(p))}
        # what the model's forward is given at each call: the decode slots,
        # and for the moe family (whose dispatch crosses rows) the blocks
        # the global batch's rows are dealt into
        self._decode_kw = {}
        if has_kv:
            slot = self.kv.attn_fn(mesh, local_heads=True) if heads else self.kv.attn_fn(mesh)
            self._decode_kw["attn_fn"] = slot
            if cfg.family == "hybrid" and self.split is not None:
                self._decode_kw["ring_fn"] = slot if self._rings_split() else None
        self._rows_kw = ({"batch_split": n_rows if self.dealt else 1}
                         if cfg.family == "moe" else {})
        like = registry.cache_shapes(cfg, ShapeConfig(shape.name, shape.seq_len,
                                                      self.rows_per_rank, "decode"))
        self._like = self._map(lambda path, x, s: _own(x, s) if path in self._computed else x,
                               like)

    def _behind_slot(self, path) -> bool:
        """Whether the K/V leaf at ``path`` is attended through the slot: every
        K/V leaf but the hybrid's rings."""
        if self.model.cfg.family == "hybrid":
            return int(path[1]) in self.model.cfg.global_layers
        return True

    def _rings_split(self) -> bool:
        """Whether the hybrid's rings are split over ``model`` (by heads, or
        by slots in sequence mode), and so attended through the slot."""
        for path, s in T.flatten_with_paths(self.cache_sh):
            if path[-1] == "k" and not self._behind_slot(path):
                return any(a == "model" for _, a in s.splits(4))
        return False

    def rows(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a global batch tensor (``data_spec``)."""
        if not self.dealt:
            return t
        idx, _ = self.mesh.batch_index()
        return t[idx * self.rows_per_rank:(idx + 1) * self.rows_per_rank]

    def _map(self, fn, cache):
        pairs = T.flatten_with_paths(cache)
        shs = T.leaves(self.cache_sh)
        return T.unflatten(cache, [fn(path, x, s) for (path, x), s in zip(pairs, shs)])

    @torch.no_grad()
    def prefill(self, batch: dict):
        """The global ``batch`` (``tokens`` ``(B, S)``, and ``patches`` or
        ``frames`` for the vlm and audio families) -> (this rank's cache, its
        slices, at the shape's capacity; its rows' last logits)."""
        tokens = batch["tokens"]
        if tokens.shape[0] != self.shape.global_batch:
            raise ValueError(f"a batch of {tokens.shape[0]} rows; the steps serve "
                             f"{self.shape.global_batch}")
        extra = {k: self.rows(v) for k, v in batch.items() if k not in ("tokens", "labels")}
        cache, logits = self.model.prefill(self.rows(tokens), **extra, **self._rows_kw)
        cache = fit_cache(cache, self._like)
        return self._map(lambda path, x, s: x if path in self._computed else _own(x, s),
                         cache), logits

    @torch.no_grad()
    def decode(self, cache, tokens: torch.Tensor):
        """One token per row of this rank, ``tokens`` ``(B_rank, 1)``,
        against this rank's cache -> (its new cache, its rows' logits). The
        K/V behind the slots are written in place; a split model's leaves
        stay its slices; every other leaf is gathered over ``model`` for the
        step and cut to its slice after."""
        step = self._map(lambda path, x, s: x if path in self._kept else _lift(x, s), cache)
        new, logits = self.model.decode_step(step, tokens, **self._decode_kw, **self._rows_kw)
        return self._map(lambda path, x, s: x if path in self._kept else _own(x, s),
                         new), logits


# ---------------------------------------------------------------------------
# Serving one arch on a spawned mesh
# ---------------------------------------------------------------------------


def capacity_for(prompt_len: int, gen: int, multiple: int = 64) -> int:
    """A decode shape's capacity for ``prompt_len + gen`` positions, rounded
    up to a multiple of ``multiple`` (so that a model axis of up to that
    many ranks splits it): 2112 for a 2048-token prompt and 32 steps."""
    return -(-(prompt_len + gen) // multiple) * multiple


def mesh_axes(world: int, data: int, model: int) -> tuple:
    """(shape, axes) of a serving mesh: (pod, data, model), pod the rest."""
    if world < 1 or world % (data * model):
        raise ValueError(f"data {data} x model {model} does not divide a world of {world}")
    return (world // (data * model), data, model), ("pod", "data", "model")


def working_bytes(model) -> int:
    """The bytes of a laid-out model's working copies: its buffers and the
    parameters that are not its blocks."""
    blocks = {id(p) for p in model.blocks.values()}
    return (sum(b.numel() * b.element_size() for b in model.buffers())
            + sum(p.numel() * p.element_size() for p in model.parameters()
                  if id(p) not in blocks))


def _sent_since(before: dict) -> dict:
    return {k: v - before.get(k, 0) for k, v in collectives.SENT.items() if v - before.get(k, 0)}


def serve_rank(spec: dict, observe=None) -> dict:
    """One rank of a sharded serve (``spawn``'s target): the model of
    ``spec["arch"]`` laid out on the rank's mesh, then each run of
    ``spec["runs"]`` (pairs of KV partition and MoE dispatch; the one pair
    ``spec["kv_partition"]``, ``spec["moe_dispatch"]`` where absent) on it:
    a prefill of the seeded batch (``launch.serve.serve_batch``), where
    ``spec["check_tokens"]`` gives a token a row, a decode step on them from
    a copy of the prefill's cache, and ``spec["gen"]`` greedy decode steps.
    ``observe(run, phase)``, where given, is called before each run's
    prefill (``"start"``) and after each of its phases (``"prefill"``,
    ``"check"``, ``"decode"``), outside the timed spans. Returns the
    layout's time and bytes, and by run its compute split, working copies'
    bytes (laid out again where the run's KV mode splits otherwise), the
    experts each MoE layer's bfloat16 banks hold (``bank_experts``), tokens,
    logits, times, peak memory and the bytes it sent by ``op@axis``
    (``sent_prefill``, and ``sent_decode`` for the check step and the
    greedy steps)."""
    from repro_torch.comm.moe_dispatch import configure
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.launch.mesh import make_mesh, rank_device
    from repro_torch.launch.serve import SEED, cut_depth, serve_batch

    dev = rank_device(spec["device"], dist.get_rank(), dist.get_backend())
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    mesh = make_mesh(*mesh_axes(spec["world"], spec["data"], spec["model"]), device=dev)
    cfg = get_smoke_config(spec["arch"]) if spec["smoke"] else get_config(spec["arch"])
    cfg = cfg.replace(attn_impl=spec["attn_impl"])
    if spec.get("layers") is not None:
        cfg = cut_depth(cfg, spec["layers"])
    B, S, gen = spec["batch"], spec["prompt_len"], spec["gen"]
    shape = ShapeConfig("serve", capacity_for(S, gen), B, "decode")
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" else (lambda: None)
    observe = observe or (lambda run, phase: None)

    sent0 = dict(collectives.SENT)
    t0 = time.perf_counter()
    runs = spec.get("runs") or [(spec["kv_partition"], spec.get("moe_dispatch"))]
    model = build_sharded(cfg, mesh, ShardingConfig(), seed=SEED)
    lay_out(model, mesh, ShardingConfig(),
            serve_split(cfg, mesh, ShardingConfig(kv_partition=runs[0][0])))
    sync()
    out = {"rank": mesh.rank, "coords": dict(mesh.coords), "arch": cfg.name,
           "layout_s": time.perf_counter() - t0, "layout_sent": _sent_since(sent0),
           "block_bytes": sum(p.numel() * p.element_size() for p in model.blocks.values()),
           "working_bytes": working_bytes(model), "runs": []}
    tokens, extra = serve_batch(cfg, B, S, dev)
    check = spec.get("check_tokens")
    for i, (kv, dispatch) in enumerate(runs):
        model.cfg = configure(cfg, dispatch) if dispatch and cfg.moe is not None else cfg
        steps = ServeSteps(model, mesh, ShardingConfig(kv_partition=kv), shape)
        sync()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
        rec = {"kv_partition": kv, "moe_dispatch": dispatch, "mode": steps.mode,
               "kv": steps.kv.name if steps.kv is not None else None,
               "split": repr(steps.split), "working_bytes": working_bytes(model),
               "bank_experts": [m.gate16.shape[0] for m in model.modules()
                                if getattr(m, "gate16", None) is not None]}
        observe(i, "start")
        s0 = dict(collectives.SENT)
        t0 = time.perf_counter()
        cache, logits = steps.prefill({"tokens": tokens, **extra})
        sync()
        rec["prefill_s"] = time.perf_counter() - t0
        rec["sent_prefill"] = _sent_since(s0)
        rec["prefill_logits"] = logits.float().cpu().numpy()
        observe(i, "prefill")
        s1 = dict(collectives.SENT)
        if check is not None:
            copy = T.map(lambda x: x.clone() if torch.is_tensor(x) else x, cache)
            _, chk = steps.decode(copy, steps.rows(torch.as_tensor(check, device=dev)))
            rec["check_logits"] = chk.float().cpu().numpy()
            del copy, chk
            observe(i, "check")
        toks = logits.argmax(dim=-1, keepdim=True)
        gen_toks = [toks]
        sync()
        t0 = time.perf_counter()
        for _ in range(gen):
            cache, logits = steps.decode(cache, toks)
            toks = logits.argmax(dim=-1, keepdim=True)
            gen_toks.append(toks)
        sync()
        rec["decode_s"] = time.perf_counter() - t0
        observe(i, "decode")
        if not bool(torch.isfinite(logits).all()):
            raise RuntimeError(f"rank {mesh.rank}: decode produced non-finite logits")
        rec.update(tokens=torch.cat(gen_toks, dim=1).cpu().numpy(),
                   logits=logits.float().cpu().numpy(), sent_decode=_sent_since(s1),
                   peak_memory_bytes=(torch.cuda.max_memory_allocated(dev)
                                      if dev.type == "cuda" else None))
        out["runs"].append(rec)
        del cache, logits, steps
    return out


def serve_sharded(arch: str, *, world: int, data: int = 1, model: int = 1,
                  kv_partition: str = "auto", moe_dispatch: Optional[str] = None,
                  smoke: bool = False, batch: int = 4, prompt_len: int = 64, gen: int = 16,
                  device="cuda", attn_impl: str = "pallas", layers: Optional[int] = None,
                  threads: Optional[int] = None) -> list:
    """Serve ``arch`` on a new world of ``world`` ranks, a (pod, data,
    model) mesh (``serve_rank`` on each, by ``launch.mesh.spawn``, over
    ``launch.mesh.choose_backend``'s backend); returns each rank's record,
    by rank. The ranks along ``model`` serve the same rows and must
    generate the same tokens: a difference raises. ``threads``: each rank's
    CPU threads (``spawn``'s)."""
    from repro_torch.launch.mesh import choose_backend, spawn

    mesh_axes(world, data, model)
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu'")
    backend = choose_backend(device, world)
    why = ("CPU tensors" if dev.type == "cpu" else "a GPU per rank" if backend == "nccl"
           else "the ranks share one GPU; NCCL refuses two ranks on one device")
    spec = {"arch": arch, "world": world, "data": data, "model": model,
            "kv_partition": kv_partition, "moe_dispatch": moe_dispatch, "smoke": smoke,
            "batch": batch, "prompt_len": prompt_len, "gen": gen, "device": str(device),
            "attn_impl": attn_impl, "layers": layers}
    ranks = spawn("repro_torch.serving.steps:serve_rank", world, backend=backend,
                  args=(spec,), threads=threads, reason=why)
    for r in ranks:
        for o in ranks:
            same_rows = all(r["coords"][a] == o["coords"][a] for a in BATCH_AXES)
            if same_rows and not (r["runs"][0]["tokens"] == o["runs"][0]["tokens"]).all():
                raise RuntimeError(f"ranks {r['rank']} and {o['rank']} share their rows but "
                                   "generated different tokens")
    return ranks
