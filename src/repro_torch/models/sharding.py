"""Parameter, batch and cache partition specs, and where a rank's shard lies.

The counterpart of ``src/repro/models/sharding.py``. Layout:
  TP   over 'model'  — d_ff / head / vocab / expert dims
  FSDP over 'data'   — the non-TP matrix dim (ZeRO-3)
  DP   over 'pod'    — params replicated; gradient sync is the pod-transport
                       chunnel Select (xla | ring | hierarchical | compressed)

Rules are name-based on the owning parameter, padded with None for any leading
stacking dims, so they apply to stacked (L, ...) layer leaves alike. A rule
names an axis only where the axis is on the mesh and divides the dim; else
the dim is replicated (hymba's vocab of 32001, the per-head biases).

The functions here are pure: names, shapes and axis sizes in, specs out. A
mesh is anything with ``axis_names`` and a ``shape`` mapping of axis sizes
(a ``launch.mesh.Mesh``; no ranks are needed). A spec is a :class:`P`. Paths are the reference's key paths: the port's trees are
``stacking.stack_layers`` of its parameter names, walked in the reference's
leaf order (``repro_torch.tree``).

:func:`local_slice` says which block of a leaf a rank holds, as JAX places
a ``NamedSharding``: each sharded dim is cut into contiguous blocks, one per
position along its axes; with a tuple of axes the first is the outermost.
:class:`Layout` holds a model's parameters on a mesh by these specs and
gathers them for the forward (``comm.collectives.gather_param``).
"""
from __future__ import annotations

import math
from contextlib import contextmanager
from typing import Dict, Mapping, Optional, Sequence, Tuple

import torch

from repro_torch import tree as T
from repro_torch.configs.base import ModelConfig, ShardingConfig

# param name -> spec for the trailing dims
_COL = ("wq", "wk", "wv", "wz", "wi", "wf", "wo_gate", "src_proj")  # (d_in, out*) -> out over model
_ROW = ("wo", "down", "out_proj")  # (in*, d_out) -> in over model
_GLU_UP = ("gate", "up")


def _norm_entry(e):
    if isinstance(e, (tuple, list)):
        e = tuple(e)
        return e[0] if len(e) == 1 else e
    return e


class P:
    """A partition spec: one entry per dim, each None, an axis name or a
    tuple of names (the first outermost). Equal where JAX's
    ``PartitionSpec`` is: a one-name tuple is that name, and trailing Nones
    count (``P("a") != P("a", None)``). Not a tuple, so that a tree walks it
    as one leaf."""

    __slots__ = ("_e",)

    def __init__(self, *entries):
        self._e = tuple(_norm_entry(e) for e in entries)

    def __iter__(self):
        return iter(self._e)

    def __len__(self) -> int:
        return len(self._e)

    def __getitem__(self, i):
        return self._e[i]

    def __eq__(self, other) -> bool:
        return isinstance(other, P) and self._e == other._e

    def __hash__(self) -> int:
        return hash(self._e)

    def __repr__(self) -> str:
        return f"P{self._e!r}"


def _pad(spec: tuple, ndim: int, shape: tuple = (), axis_sizes: Optional[dict] = None) -> P:
    full = (None,) * (ndim - len(spec)) + tuple(spec)
    if axis_sizes and shape:
        fixed = []
        for dim, ax in zip(shape, full):
            if ax is None:
                fixed.append(None)
                continue
            axes = ax if isinstance(ax, tuple) else (ax,)
            if any(a not in axis_sizes for a in axes):
                fixed.append(None)
                continue
            n = math.prod(axis_sizes[a] for a in axes)
            fixed.append(ax if (n > 0 and dim % n == 0) else None)
        full = tuple(fixed)
    return P(*full)


def param_spec(path: Sequence[str], shape: Sequence[int], sh: ShardingConfig,
               axis_sizes: Optional[dict] = None) -> P:
    """The spec of the parameter at ``path`` (the reference's key path) of
    ``shape``, the reference's rules."""
    shape = tuple(shape)

    def pad(spec: tuple, ndim: int) -> P:
        return _pad(spec, ndim, shape, axis_sizes)

    fsdp = "data" if sh.fsdp else None
    names = [str(k) for k in path]
    ndim = len(shape)
    owner = None
    for n in reversed(names):
        if not n.isdigit() and n not in ("w", "b", "scale", "bias", "table"):
            owner = n
            break
    leaf = names[-1]
    in_moe = "moe" in names

    if leaf == "table" or owner == "embed":
        return pad(("model", fsdp), ndim)
    if owner == "lm_head":
        return pad((fsdp, "model"), ndim) if leaf == "w" else pad(("model",), ndim)
    if owner == "router":
        return pad((fsdp, None), ndim) if leaf == "w" else pad((None,), ndim)
    if in_moe and owner in _GLU_UP:  # (E, D, F)
        return pad(("model", fsdp, None), ndim)
    if in_moe and owner == "down":  # (E, F, D)
        return pad(("model", None, fsdp), ndim)
    if leaf in ("scale", "bias") or owner in ("r",) or leaf in ("dt_bias", "D", "conv_b"):
        return pad((), ndim)
    if leaf == "A_log" or owner == "A_log":
        return pad(("model", None), ndim)
    if leaf == "conv_w" or owner == "conv_w":
        return pad((None, "model"), ndim)
    if owner in _COL or owner in _GLU_UP or owner in ("in_proj", "x_proj"):
        if leaf == "b":
            return pad(("model",), ndim)
        return pad((fsdp, "model"), ndim)
    if owner == "dt_proj":  # (dt_rank, d_in)
        return pad((None, "model"), ndim) if leaf == "w" else pad(("model",), ndim)
    if owner in _ROW:
        if leaf == "b":
            return pad((), ndim)
        return pad(("model", fsdp), ndim)
    return pad((), ndim)  # replicate by default (small leaves)


def param_specs(shapes, sh: ShardingConfig, mesh=None):
    """A tree of :class:`P` of ``shapes``' structure (leaves with a
    ``.shape``: tensors, meta tensors, arrays)."""
    sizes = dict(mesh.shape) if mesh is not None else None
    pairs = T.flatten_with_paths(shapes)
    return T.unflatten(shapes, [param_spec(tuple(str(k) for k in path), tuple(leaf.shape), sh,
                                           sizes) for path, leaf in pairs])


# ---------------------------------------------------------------------------
# Batch / cache specs
# ---------------------------------------------------------------------------


def batch_axes(mesh) -> tuple:
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def data_spec(shape: Sequence[int], mesh, *, batch_dim: int = 0) -> P:
    """Shard the batch dim over pod+data when divisible, else replicate."""
    axes = batch_axes(mesh)
    n = math.prod(mesh.shape[a] for a in axes)
    spec = [None] * len(shape)
    if shape[batch_dim] % n == 0 and shape[batch_dim] > 0:
        spec[batch_dim] = axes if len(axes) > 1 else axes[0]
    return P(*spec)


def kv_partition_mode(cfg: ModelConfig, mesh, sh: ShardingConfig) -> str:
    """'heads' when kv heads divide the model axis, else 'sequence'."""
    if sh.kv_partition != "auto":
        return sh.kv_partition
    m = mesh.shape.get("model", 1)
    return "heads" if cfg.num_kv_heads % m == 0 else "sequence"


def cache_spec_for(shape: Sequence[int], cfg: ModelConfig, mesh, sh: ShardingConfig) -> P:
    """Spec for a KV-cache leaf shaped (..., B, S, KH, hd)."""
    mode = kv_partition_mode(cfg, mesh, sh)
    axes = batch_axes(mesh)
    b_ax = axes if len(axes) > 1 else (axes[0] if axes else None)
    ndim = len(shape)
    n_batch = math.prod(mesh.shape[a] for a in axes)
    b_spec = b_ax if (shape[ndim - 4] % max(n_batch, 1) == 0) else None
    if mode == "heads":
        spec = (b_spec, None, "model", None)
    else:
        m = mesh.shape.get("model", 1)
        s_ok = shape[ndim - 3] % max(m, 1) == 0
        spec = (b_spec, "model" if s_ok else None, None, None)
    return P(*((None,) * (ndim - 4) + spec))


# ---------------------------------------------------------------------------
# Where a rank's shard lies
# ---------------------------------------------------------------------------


def _entries(spec: P, ndim: int) -> tuple:
    return tuple(spec) + (None,) * (ndim - len(spec))


def local_slice(shape: Sequence[int], spec: P, mesh_shape: Mapping[str, int],
                coords: Mapping[str, int]) -> Tuple[slice, ...]:
    """The index of the block of a ``shape`` leaf laid out by ``spec`` that
    the rank at ``coords`` holds: one contiguous block of each sharded dim,
    numbered row-major over the dim's axes (the first outermost)."""
    out = []
    for dim, ax in zip(shape, _entries(spec, len(shape))):
        if ax is None:
            out.append(slice(None))
            continue
        idx, n = 0, 1
        for a in (ax if isinstance(ax, tuple) else (ax,)):
            size = mesh_shape.get(a, 1)
            idx, n = idx * size + (coords.get(a, 0) if size > 1 else 0), n * size
        if dim % n:
            raise ValueError(f"dim {dim} of {tuple(shape)} does not split over {ax} ({n})")
        per = dim // n
        out.append(slice(idx * per, (idx + 1) * per))
    return tuple(out)


class NamedSharding:
    """A spec on a mesh: which block of a leaf this mesh's rank holds."""

    def __init__(self, mesh, spec: P):
        self.mesh, self.spec = mesh, P(*spec)

    def index(self, shape: Sequence[int]) -> Tuple[slice, ...]:
        return local_slice(shape, self.spec, self.mesh.shape, self.mesh.coords)

    def splits(self, ndim: int) -> Tuple[Tuple[int, str], ...]:
        """(dim, axis) for every axis of more than one rank that the spec
        cuts a dim of, in dim order (within a dim, outermost first)."""
        out = []
        for d, ax in enumerate(_entries(self.spec, ndim)):
            for a in (() if ax is None else ax if isinstance(ax, tuple) else (ax,)):
                if self.mesh.shape.get(a, 1) > 1:
                    out.append((d, a))
        return tuple(out)

    def local(self, full):
        """This rank's block of ``full`` (a tensor or an array; a scalar or
        an int as it is)."""
        if not hasattr(full, "shape") or not self.splits(len(full.shape)):
            return full
        return full[self.index(full.shape)]

    def full(self, shard: torch.Tensor, op: str = "gather_state") -> torch.Tensor:
        """The full tensor from every rank's block, outside autograd."""
        from repro_torch.comm.collectives import gather_dim

        for dim, axis in reversed(self.splits(shard.dim())):
            shard = gather_dim(shard, self.mesh, axis, dim, op=op)
        return shard

    def __repr__(self) -> str:
        return f"NamedSharding({self.mesh.shape}, {self.spec})"


def per_layer(spec_tree: Mapping, stacks: Mapping[str, int]) -> Dict[str, P]:
    """The port's parameter names -> specs, from the spec tree of
    ``stacking.stack_layers``' layout over ``stacks`` (a model's
    ``stacks()``): a stacked layer leaf's spec without its leading (layer)
    entry for each ``<prefix>.{i}.<leaf>``."""
    from repro_torch.models.stacking import unstack_layers

    class _Stacked:  # indexed by layer as unstack_layers indexes a stacked leaf
        def __init__(self, spec):
            self.spec = spec

        def __getitem__(self, i):
            return P(*self.spec[1:])

    out = unstack_layers(T.map(_Stacked, spec_tree), stacks)
    return {n: s.spec if isinstance(s, _Stacked) else s for n, s in out.items()}


class Layout:
    """A model's parameters on a mesh: each parameter's sharding by name and
    its full shape. A sharded model's parameters are the local blocks;
    :meth:`gathered` lets its forward read the full tensors."""

    def __init__(self, mesh, specs: Mapping[str, P], shapes: Mapping[str, Sequence[int]]):
        self.mesh = mesh
        self.shapes = {n: tuple(s) for n, s in shapes.items()}
        self.shardings = {n: NamedSharding(mesh, s) for n, s in specs.items()}
        self.splits = {n: self.shardings[n].splits(len(self.shapes[n])) for n in self.shardings}
        # the batch axes gathered first, the innermost of a dim before the
        # outer ones: the backward's reduce-scatter (a batch axis) then runs
        # on the smallest tensor, after the other axes' blocks are cut out
        self._gather_order = {n: sorted(reversed(sp), key=lambda da: da[1] not in ("pod", "data"))
                              for n, sp in self.splits.items()}

    def local(self, name: str, full: torch.Tensor) -> torch.Tensor:
        """This rank's block of the full tensor of ``name``."""
        return self.shardings[name].local(full)

    def full(self, name: str, shard: torch.Tensor, op: str = "gather_grad") -> torch.Tensor:
        """The full tensor of ``name`` from this rank's block, outside autograd."""
        return self.shardings[name].full(shard, op)

    def axes(self, name: str) -> Tuple[str, ...]:
        """The axes of more than one rank that ``name`` is split over."""
        return tuple(a for _, a in self.splits[name])

    def gather(self, name: str, shard: torch.Tensor) -> torch.Tensor:
        """The full tensor of ``name`` from this rank's block, differentiable
        (``collectives.gather_param`` over each axis it is split on)."""
        from repro_torch.comm.collectives import gather_param

        for dim, axis in self._gather_order[name]:
            shard = gather_param(shard, self.mesh, axis, dim)
        return shard

    @contextmanager
    def gathered(self, module: torch.nn.Module, prefix: str = ""):
        """Within the block, each split parameter of ``module`` (named
        ``prefix`` + its name in ``module``) reads as its full tensor, gathered
        now; the blocks are put back after."""
        swaps = []
        try:
            for mod_name, mod in module.named_modules():
                for pname, p in list(mod._parameters.items()):
                    name = f"{prefix}{mod_name + '.' if mod_name else ''}{pname}"
                    if p is None or not self.splits.get(name):
                        continue
                    swaps.append((mod, pname, p))
                    mod._parameters[pname] = self.gather(name, p)
            yield
        finally:
            for mod, pname, p in swaps:
                mod._parameters[pname] = p
