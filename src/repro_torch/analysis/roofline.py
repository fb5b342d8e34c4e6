"""Three-term roofline of a step on a mesh of H100s.

  compute    = FLOPs_per_device / peak_bf16
  memory     = HBM_bytes_per_device / hbm_bw
  collective = NVLink_bytes / nvlink_bw + InfiniBand_bytes / ib_bw   (per device)

The counterpart of ``src/repro/analysis/roofline.py``, priced on the H100 of
``launch.mesh.HW`` (the reference prices a TPU v5e). FLOPs and HBM bytes
come from the analytic model (``analysis.flops``, where its docstring says
why). Collective bytes come from the layout, not from HLO (the port has
none, so the reference's ``hloparse`` has no counterpart):
:func:`step_collectives` adds up the collectives the port's own steps issue,
by ``op@axis`` as ``comm.collectives.SENT`` names them, and a test holds it
to ``SENT`` from a gloo run of the same steps (``tests/test_torch_analysis.py``).

Tiers. An HGX H100 node holds 8 GPUs on NVLink, and nodes meet over
InfiniBand. Ranks are laid out row-major over the mesh axes (``launch.mesh``),
so the ranks along an axis sit on one node only when every group of them
falls in one block of 8 consecutive ranks (:func:`axis_tier`). On the
production meshes every axis crosses nodes: ``model`` (16 consecutive ranks)
spans two nodes, ``data`` (stride 16) and ``pod`` (stride 256) sixteen and
two. So every collective byte there rides InfiniBand, and
``dcn_bytes_per_dev`` (the bytes that cross nodes) equals
``coll_bytes_per_dev``.
"""
from __future__ import annotations

import math
from collections import Counter
from dataclasses import dataclass

from repro_torch.analysis import flops as F
from repro_torch.configs.base import ModelConfig, ShapeConfig, ShardingConfig, TrainConfig
from repro_torch.launch.mesh import BATCH_AXES, HW

F32, BF16 = 4, 2


@dataclass
class Roofline:
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    flops_per_dev: float
    bytes_per_dev: float
    coll_bytes_per_dev: float
    dcn_bytes_per_dev: float
    model_flops: float
    hlo_useful_ratio: float  # MODEL_FLOPS / implementation FLOPs (the reference's name)
    step_time_s: float  # max of the three terms (no-overlap bound is their sum)
    mfu: float  # model_flops / (chips * peak * step_time)

    def to_dict(self):
        return {k: getattr(self, k) for k in self.__dataclass_fields__}


def axis_tier(mesh_shape: dict, axis: str, node_gpus: int = HW["node_gpus"]) -> str:
    """``"nvlink"`` when every group of ranks along ``axis`` lies in one
    node of ``node_gpus`` consecutive ranks, else ``"ib"``."""
    n = mesh_shape[axis]
    stride = math.prod(mesh_shape[a] for a in list(mesh_shape)[list(mesh_shape).index(axis) + 1:])
    size = math.prod(mesh_shape.values())
    for base in range(size):
        if (base // stride) % n == 0 and base // node_gpus != (base + (n - 1) * stride) // node_gpus:
            return "ib"
    return "nvlink"


def split_tiers(sent: dict, mesh_shape: dict) -> tuple:
    """(NVLink bytes, InfiniBand bytes) of ``sent`` (bytes by ``op@axis``)."""
    nvlink = ib = 0.0
    for key, nbytes in sent.items():
        axis = key.rsplit("@", 1)[-1]
        if axis_tier(mesh_shape, axis) == "ib":
            ib += nbytes
        else:
            nvlink += nbytes
    return nvlink, ib


def analyze(sent: dict, cfg: ModelConfig, shape: ShapeConfig, mesh_shape: dict) -> Roofline:
    """The roofline of one step of ``cfg`` at ``shape`` on ``mesh_shape``,
    with ``sent`` the bytes one device sends by ``op@axis``
    (:func:`step_collectives`)."""
    n_chips = math.prod(mesh_shape.values())
    cost = F.step_cost(cfg, shape, mesh_shape)
    fpd = cost.flops / n_chips
    bpd = cost.bytes_hbm / n_chips
    nvlink, ib = split_tiers(sent, mesh_shape)

    compute_s = fpd / HW["peak_flops_bf16"]
    memory_s = bpd / HW["hbm_bw"]
    collective_s = nvlink / HW["nvlink_bw"] + ib / HW["ib_bw"]
    terms = {"compute": compute_s, "memory": memory_s, "collective": collective_s}
    dominant = max(terms, key=terms.get)
    step = max(terms.values())
    mfu = cost.model_flops / (n_chips * HW["peak_flops_bf16"] * step) if step > 0 else 0.0
    return Roofline(
        compute_s=compute_s,
        memory_s=memory_s,
        collective_s=collective_s,
        dominant=dominant,
        flops_per_dev=fpd,
        bytes_per_dev=bpd,
        coll_bytes_per_dev=nvlink + ib,
        dcn_bytes_per_dev=ib,
        model_flops=cost.model_flops,
        hlo_useful_ratio=cost.model_flops / max(cost.flops, 1.0),
        step_time_s=step,
        mfu=mfu,
    )


# ---------------------------------------------------------------------------
# The collectives of the port's steps, from the layout
# ---------------------------------------------------------------------------


class _Sent(Counter):
    """Bytes by ``op@axis``, each call's count truncated as ``SENT``'s is."""

    def all_reduce(self, op: str, axis: str, n: int, nbytes: float) -> None:
        if n > 1:
            self[f"{op}@{axis}"] += int(2 * (n - 1) / n * nbytes)

    def all_gather(self, op: str, axis: str, n: int, nbytes: float) -> None:
        if n > 1:
            self[f"{op}@{axis}"] += int((n - 1) * nbytes)

    def sends(self, op: str, axis: str, count: int, nbytes: float) -> None:
        """``count`` point-to-point steps of ``nbytes`` (a ring)."""
        if count > 0:
            self[f"{op}@{axis}"] += count * int(nbytes)


def local_numel(sharding, shape) -> int:
    """The elements of the block of a ``shape`` leaf that ``sharding``'s
    rank holds."""
    return math.prod(len(range(*s.indices(d))) for s, d in zip(sharding.index(shape), shape))


def train_layout(model, mesh, sh: ShardingConfig, transport: str):
    """(the trainer's gradient stack for ``transport``, built on the CPU:
    the accounting reads its names and axes and moves no tensor; the
    parameters' spec tree in the reference's layout, less the axes the
    stack takes manual), as ``train.step.shardings_for`` lays them out."""
    from repro_torch import tree as T
    from repro_torch.comm.chunnels import stack_manual_axes, transport_chunnels
    from repro_torch.models import registry
    from repro_torch.train.step import _drop_axes

    chunnels = transport_chunnels(transport, mesh, "cpu")
    manual = stack_manual_axes(chunnels) & set(mesh.axis_names)
    specs = registry.param_specs(model, sh, mesh)
    if manual:
        specs = T.map(lambda s: _drop_axes(s, manual), specs)
    return chunnels, specs


def _transport_bytes(out: _Sent, ch, mesh, numel: int) -> None:
    """The transport ``ch``'s collectives on a flat float32 gradient of
    ``numel`` elements (``comm.collectives``' schedules)."""
    from repro_torch.comm.collectives import dcn_bytes_factor

    name = type(ch).__name__
    if name in ("GradHierarchical", "GradHierCompressed"):
        nf, fast, slow = mesh.shape[ch.fast_axis], ch.fast_axis, ch.slow_axis
        shard = (numel + (-numel) % nf) // nf
        out.sends("reduce_scatter", fast, nf - 1, shard * F32)
        if name == "GradHierarchical":
            out.all_reduce("all_reduce", slow, mesh.shape[slow], shard * F32)
        else:
            _compressed(out, slow, mesh.shape[slow], shard, ch.block)
        out.all_gather("all_gather", fast, nf, shard * F32)
        return
    n = mesh.shape[ch.axis]
    if name == "GradPsum":
        out.all_reduce("all_reduce", ch.axis, n, numel * F32)
    elif name == "GradRing":
        out.sends("send", ch.axis, 2 * (n - 1), -(-numel // n) * F32)
    elif name == "GradCompressed":
        _compressed(out, ch.axis, n, numel, ch.block)
    elif name == "GradLocalSGD":  # one all-reduce every sync_every steps
        out.all_reduce("all_reduce", ch.axis, n,
                       numel * F32 * dcn_bytes_factor("localsgd", sync_every=ch.sync_every))
    else:
        raise ValueError(f"no byte count for transport {name}")


def _compressed(out: _Sent, axis: str, n: int, numel: int, block: int) -> None:
    """``compressed_allgather_sum``: the int8 codes and the f32 scales."""
    blocks = -(-numel // block)
    out.all_gather("all_gather", axis, n, blocks * block)
    out.all_gather("all_gather", axis, n, blocks * F32)


def train_collectives(model, mesh, sh: ShardingConfig = ShardingConfig(), *,
                      transport: str = "xla", tcfg: TrainConfig = TrainConfig(),
                      shape: ShapeConfig | None = None) -> Counter:
    """Bytes one rank sends in one ``train.step`` step of ``model`` (full
    parameter shapes, as built: a meta model will do) on ``mesh`` (a
    ``launch.mesh.Mesh`` or ``AbstractMesh``) for a global batch of
    ``shape`` (the moe family's dispatches read it), by ``op@axis``:

    - the forward's parameter gathers (``gather_param``, each layer's twice
      under remat: the backward recomputes it) and their backward over a
      batch axis (``grad_reduce_scatter``), per microbatch; under the
      compute split over ``model`` (``models.pshard``: dense, vlm, hybrid) a
      leaf it reads as its block is gathered over the batch axes only, one
      it reads as a shared part (``in_proj``, ``x_proj``, KV heads that
      |model| does not divide) also over ``model``, with a reduce-scatter
      backward there, and a replicated leaf read in part (``conv_b``,
      ``dt_bias``, ``D``) sums its gradient over ``model``;
    - the split's activations (:func:`_split_layer_train`), per layer and
      microbatch: on the sequence-parallel residual (|model| divides S) the
      gathers and reduce-scatters over S (``gather_seq``, ``scatter_seq``)
      and their backwards (``grad_scatter_seq``, ``grad_gather_seq``), else
      the row products' sums (``sum_partials``) and the "f" conjugates'
      backward (``grad_all_reduce``); a leaf that the rank reads whole on
      its own positions (the norms' scales) sums its gradient over
      ``model``;
    - the vocabulary split's (:func:`_vocab_ops`), per microbatch: the
      embedding's sum, the head's input gathered over S, the loss's three
      sums a chunk;
    - the moe family's dispatches, forward and backward, per layer and
      microbatch (:func:`_moe_layer_train`);
    - the mean over the batch axes the transport leaves automatic
      (``all_reduce``) and the agreement over ``model`` (``grad_agree``);
    - with a transport: the gradient's and its state's gathers
      (``gather_grad``, ``gather_state``) and the transport's own schedule;
    - AdamW's norm (``grad_norm``) and ZeRO-1 gather (``zero1_gather``);
    - the metrics' mean (``all_reduce``)."""
    from repro_torch import tree as T
    from repro_torch.comm.chunnels import stack_manual_axes
    from repro_torch.models import registry
    from repro_torch.models.pshard import model_split
    from repro_torch.models.sharding import Layout, NamedSharding, per_layer
    from repro_torch.models.stacking import group_size
    from repro_torch.train.step import _zero1_pod

    cfg = model.cfg
    chunnels, specs = train_layout(model, mesh, sh, transport)
    manual = stack_manual_axes(chunnels) & set(mesh.axis_names)
    shapes_tree = registry.param_shapes(model)
    stacks = model.stacks()
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    layout = Layout(mesh, per_layer(specs, stacks), shapes)
    local = {n: local_numel(layout.shardings[n], shapes[n]) for n in shapes}
    out = _Sent()
    n_mb = max(tcfg.microbatches, 1)

    split = model_split(cfg, mesh)
    if (split is not None or cfg.family == "moe") and shape is None:
        raise ValueError("the compute split's and the moe dispatch's bytes need the "
                         "batch's shape")
    if shape is not None:  # this rank's rows
        n_rows = math.prod(mesh.shape[a] for a in BATCH_AXES if a in mesh.axis_names)
        rows = shape.global_batch // n_rows if shape.global_batch % n_rows == 0 \
            else shape.global_batch
    if split is not None:
        split = split.at(shape.seq_len)
        g = group_size(cfg.num_layers, model._remat_group())
        for i in range(cfg.num_layers):
            for _ in range(n_mb):  # under remat, all but a unit's last "g" run again
                _split_layer_train(out, cfg, split, rows // n_mb, shape.seq_len,
                                   cfg.remat != "none", last=(i + 1) % g == 0)
        if split.vocab is not None:
            for _ in range(n_mb):
                for fwd, bwd in _vocab_ops(cfg, split, rows // n_mb, shape.seq_len, train=True,
                                           loss_chunk=cfg.loss_chunk):
                    _issue(out, fwd, mesh.shape["model"])
                    _issue(out, bwd, mesh.shape["model"])

    # forward gathers, and the backward's reduce-scatter over a batch axis
    # (and over model for a leaf the split reads as a shared part)
    for name in shapes:
        passes = 2 if cfg.remat != "none" and name.split(".", 1)[0] in stacks else 1
        cur = local[name]
        read = split.read_of(name) if split is not None else None
        how = read.how if read is not None else "whole"
        for _dim, axis in layout._gather_order[name]:
            n = mesh.shape[axis]
            if axis == "model" and how == "block":
                continue
            for _ in range(passes * n_mb):
                out.all_gather("gather_param", axis, n, cur * F32)
            if axis in BATCH_AXES or how == "shared":
                out.sends("grad_reduce_scatter", axis, (n - 1) * n_mb, cur * F32)
            cur *= n
        if how == "shared" and "model" not in layout.axes(name):
            for _ in range(n_mb):  # enters through ``replicated``
                out.all_reduce("grad_all_reduce", "model", mesh.shape["model"], cur * F32)

    if cfg.family == "moe":
        for _ in range(cfg.num_layers * n_mb):
            _moe_layer_train(out, cfg, mesh, rows // n_mb, shape.seq_len,
                             shape.global_batch // rows)

    batch = [a for a in BATCH_AXES if a in mesh.axis_names and mesh.shape[a] > 1]
    shared = [a for a in mesh.axis_names if a not in BATCH_AXES and mesh.shape[a] > 1]
    for a in (a for a in batch if a not in manual):
        rest = sum(local[n] for n in shapes if a not in layout.axes(n))
        out.all_reduce("all_reduce", a, mesh.shape[a], rest * F32)
    for a in shared:
        rep = [n for n in shapes if a not in layout.axes(n)]
        if rep:
            out.all_reduce("grad_agree", a, mesh.shape[a], sum(local[n] for n in rep) * F32)

    if chunnels:
        for name in shapes:
            cur = local[name]
            for _dim, axis in reversed(layout.splits[name]):
                out.all_gather("gather_grad", axis, mesh.shape[axis], cur * F32)
                cur *= mesh.shape[axis]
        ef = [ch for ch in chunnels if getattr(ch, "error_feedback", False)]
        for _ in ef:  # the error-feedback residuals, laid out by the parameters' specs
            for leaf, spec in zip(T.leaves(shapes_tree), T.leaves(specs)):
                sharding = NamedSharding(mesh, spec)
                cur = local_numel(sharding, tuple(leaf.shape))
                for _dim, axis in reversed(sharding.splits(leaf.dim())):
                    out.all_gather("gather_state", axis, mesh.shape[axis], cur * F32)
                    cur *= mesh.shape[axis]
        numel = sum(math.prod(s) for s in shapes.values())
        for ch in chunnels:
            _transport_bytes(out, ch, mesh, numel)

    # AdamW: the norm's squares over each group of axes, then ZeRO-1
    groups = {tuple(a for _, a in layout.splits[n]) for n in shapes}
    for axes in sorted(groups):
        for a in axes:
            out.all_reduce("grad_norm", a, mesh.shape[a], F32)
    m_specs = per_layer(T.map(lambda s, t: _zero1_pod(s, tuple(t.shape), mesh), specs,
                              shapes_tree), stacks)
    for name in shapes:
        m_split = NamedSharding(mesh, m_specs[name]).splits(len(shapes[name]))
        if any(a == "pod" and (d, a) not in layout.splits[name] for d, a in m_split):
            n = mesh.shape["pod"]
            out.all_gather("zero1_gather", "pod", n, local[name] // n * F32)

    for a in batch + shared:  # loss and gradient norm
        out.all_reduce("all_reduce", a, mesh.shape[a], 2 * F32)
    return out


def _moe_layer(out: _Sent, cfg: ModelConfig, mesh, rows: int, S: int, batch_split: int) -> None:
    """One ``models.moe.moe_ffn`` call on ``rows`` rows of ``S`` positions
    (bfloat16 activations), its dispatch resolved as ``moe_ffn`` does."""
    from repro_torch.models.moe import capacity

    D, E = cfg.d_model, cfg.moe.num_experts
    axes = mesh.axis_names
    b_axes = [a for a in BATCH_AXES if a in axes]
    n_batch = math.prod(mesh.shape[a] for a in b_axes)
    n = mesh.shape["model"] if "model" in axes else 1
    manual_ok = ("model" in axes and "data" in axes and (rows * batch_split) % n_batch == 0
                 and S % n == 0 and E % n == 0)
    impl = cfg.moe.dispatch
    if impl in ("alltoall", "allgather") and manual_ok:
        T_loc = rows * S // n
        if impl == "alltoall":
            block = E // n * capacity(T_loc, cfg) * D * BF16
            out.all_gather("all_to_all", "model", n, block)
            out.all_gather("all_to_all", "model", n, block)
            out.all_gather("all_gather", "model", n, T_loc * D * BF16)
        else:
            out.all_gather("all_gather", "model", n, T_loc * D * BF16)
            out.all_reduce("all_reduce", "model", n, n * T_loc * D * F32)
        for a in ("model", "data"):  # the aux loss's mean
            out.all_reduce("all_reduce", a, mesh.shape[a], F32)
        return
    if batch_split > 1:  # the global batch's tokens gathered, innermost axis first
        cur = rows * S * D * BF16
        for a in reversed(b_axes):
            out.all_gather("all_gather", a, mesh.shape[a], cur)
            cur *= mesh.shape[a]


def _moe_layer_train(out: _Sent, cfg: ModelConfig, mesh, rows: int, S: int,
                     batch_split: int) -> None:
    """One training ``moe_ffn`` (``comm.collectives``' differentiable
    collectives): the forward's collectives, then the backward's
    (``grad_<op>``). A layer recomputed under remat issues only those of its
    forward's collectives that precede its last saved activation (the
    recomputation stops there), which are the all-to-alls and ``allgather``'s
    row gather: so they count twice (held to ``SENT`` under ``"full"``)."""
    from repro_torch.models.moe import capacity

    D, E = cfg.d_model, cfg.moe.num_experts
    axes = mesh.axis_names
    b_axes = [a for a in BATCH_AXES if a in axes]
    n_batch = math.prod(mesh.shape[a] for a in b_axes)
    n = mesh.shape["model"] if "model" in axes else 1
    manual_ok = ("model" in axes and "data" in axes and (rows * batch_split) % n_batch == 0
                 and S % n == 0 and E % n == 0)
    impl = cfg.moe.dispatch
    remat = cfg.remat != "none"
    if impl in ("alltoall", "allgather") and manual_ok:
        T_loc = rows * S // n
        _moe_layer(out, cfg, mesh, rows, S, batch_split)
        if impl == "alltoall":
            block = E // n * capacity(T_loc, cfg) * D * BF16
            for _ in range(2):
                if remat:
                    out.all_gather("all_to_all", "model", n, block)
                out.all_gather("grad_all_to_all", "model", n, block)
        else:
            if remat:
                out.all_gather("all_gather", "model", n, T_loc * D * BF16)
            out.sends("grad_reduce_scatter", "model", n - 1, T_loc * D * BF16)
        out.all_reduce("grad_all_reduce", "data", mesh.shape["data"], F32)  # the aux's mean
        out.all_reduce("grad_all_reduce", "model", n, D * E * F32)  # the router
        for _ in range(3):  # the banks' experts
            out.all_gather("grad_all_gather", "model", n, E // n * D * cfg.moe.d_ff_expert * BF16)
        out.all_gather("grad_all_gather", "model", n, T_loc * D * BF16)  # the rows' slice
        return
    if batch_split > 1:  # the global batch's rows: gathered, and reduce-scattered back
        cur = rows * S * D * BF16
        for a in reversed(b_axes):
            for _ in range(2 if remat else 1):
                out.all_gather("all_gather", a, mesh.shape[a], cur)
            out.sends("grad_reduce_scatter", a, mesh.shape[a] - 1, cur)
            cur *= mesh.shape[a]


def _split_ops(cfg: ModelConfig, split, rows: int, S: int) -> list:
    """The collectives of one split layer on ``rows`` rows of ``S``
    positions, in the forward's order: each a pair (forward, backward) of
    ``(kind, op, nbytes)`` (kind a ``_Sent`` method; None where there is
    none). With the residual whole (``split.seq`` None) the "f" is the
    identity, its backward a float32 sum (``grad_all_reduce``), and the "g"
    a float32 sum (``sum_partials``); under ``seq`` the "f" (and a whole
    block's input) is ``gather_seq`` of the rank's positions in bfloat16,
    its backward the float32 reduce-scatter ``grad_scatter_seq``, and the
    "g" the float32 reduce-scatter ``scatter_seq``, its backward
    ``grad_gather_seq`` of the bfloat16 cotangent. Dense and vlm: the
    attention's (heads, or its input gathered when whole) and the MLP's
    (d_ff). The hybrid: one input for both branches, the SSM's ``x_proj``
    sum over every position (d_in), the split branches' outputs side by
    side, the MLP's."""
    from repro_torch.models.ssm import dt_rank

    m, D = split.mesh.shape["model"], cfg.d_model
    full = rows * S
    own = rows * S // m

    def f(width):
        if split.seq is not None:
            return (("all_gather", "gather_seq", own * width * BF16),
                    ("sends", "grad_scatter_seq", own * width * F32))
        return (None, ("all_reduce", "grad_all_reduce", full * width * F32))

    def g(width):
        if split.seq is not None:
            return (("sends", "scatter_seq", own * width * F32),
                    ("all_gather", "grad_gather_seq", own * width * BF16))
        return (("all_reduce", "sum_partials", full * width * F32), None)

    heads, d_in = split.heads is not None, split.d_in is not None
    ops = []
    if cfg.family == "hybrid":
        if split.seq is not None or heads or d_in:
            ops.append(f(D))
        if d_in:
            proj = dt_rank(D, cfg.ssm) + 2 * cfg.ssm.state_dim
            ops += [(("all_reduce", "sum_partials", full * proj * F32), None),
                    (None, ("all_reduce", "grad_all_reduce", full * proj * F32))]
        if heads or d_in:
            ops.append(g(D * (heads + d_in)))
    elif heads:
        ops += [f(D), g(D)]
    elif split.seq is not None:  # the whole attention reads every position
        ops.append(f(D))
    if split.d_ff is not None:
        ops += [f(D), g(D)]
    return ops


def _issue(out: _Sent, op, m: int) -> None:
    if op is None:
        return
    kind, name, nbytes = op
    if kind == "sends":  # a reduce-scatter: m - 1 ring steps of the rank's block
        out.sends(name, "model", m - 1, nbytes)
    else:
        getattr(out, kind)(name, "model", m, nbytes)


def _split_layer(out: _Sent, cfg: ModelConfig, split, rows: int, S: int) -> None:
    """One split layer's forward collectives (:func:`_split_ops`), once."""
    for fwd, _bwd in _split_ops(cfg, split, rows, S):
        _issue(out, fwd, split.mesh.shape["model"])


def _split_layer_train(out: _Sent, cfg: ModelConfig, split, rows: int, S: int,
                       remat: bool, last: bool) -> None:
    """One split layer in training: its forward's collectives, each run
    again where remat recomputes it (the recomputation stops at the last
    saved activation, so the layer's final "g", the MLP's, runs once in the
    last layer of a checkpointed unit), and the backward's."""
    m = split.mesh.shape["model"]
    ops = _split_ops(cfg, split, rows, S)
    for i, (fwd, bwd) in enumerate(ops):
        trailing = split.d_ff is not None and i == len(ops) - 1
        for _ in range(2 if remat and not (trailing and last) else 1):
            _issue(out, fwd, m)
        _issue(out, bwd, m)


def _vocab_ops(cfg: ModelConfig, split, rows: int, S: int, *, train: bool,
               loss_chunk: int | None = None) -> list:
    """The vocabulary split's collectives outside the layers, as
    :func:`_split_ops` gives them: the embedding's sum (``scatter_embed`` to
    the rank's positions under ``seq``, its backward ``grad_gather_seq``;
    else ``embed_sum``, bfloat16). Training: the final norm's output into
    the head (``gather_seq``, its backward ``grad_scatter_seq``, float32;
    with the residual whole, ``grad_all_reduce``), and the loss's three
    float32 sums a chunk (``loss_max``, ``loss_gold``, ``loss_sumexp``),
    each twice where the chunk is recomputed. Serving: the last position's
    row from the last rank of ``model`` (``last_row``, sent by it alone)
    and the logits' gather (``gather_logits``)."""
    m, D = split.mesh.shape["model"], cfg.d_model
    Vl = cfg.vocab_padded // m
    own = rows * S // m
    if split.seq is not None:
        ops = [(("sends", "scatter_embed", own * D * BF16),
                ("all_gather", "grad_gather_seq", own * D * BF16) if train else None)]
    else:
        ops = [(("all_reduce", "embed_sum", rows * S * D * BF16), None)]
    if train:
        if split.seq is not None:
            ops.append((("all_gather", "gather_seq", own * D * BF16),
                        ("sends", "grad_scatter_seq", own * D * F32)))
        else:
            ops.append((None, ("all_reduce", "grad_all_reduce", rows * S * D * F32)))
        chunked = loss_chunk is not None and loss_chunk < S
        c = loss_chunk if chunked else S
        for _ in range(S // c):
            for _ in range(2 if chunked else 1):
                ops += [(("all_reduce", name, rows * c * F32), None)
                        for name in ("loss_max", "loss_gold", "loss_sumexp")]
        return ops
    if split.seq is not None and split.mesh.coords.get("model", 0) == m - 1:
        ops.append((("all_gather", "last_row", rows * D * BF16), None))
    ops.append((("all_gather", "gather_logits", rows * Vl * BF16), None))
    return ops


def serve_collectives(cfg: ModelConfig, shape: ShapeConfig, mesh,
                      sh: ShardingConfig = ShardingConfig()) -> Counter:
    """Bytes one rank sends in one ``serving.steps.ServeSteps`` step at a
    ``shape`` of kind ``"prefill"`` (the prompt of ``shape.seq_len``
    positions) or ``"decode"`` (one token against a cache of
    ``shape.seq_len``), by ``op@axis``. The layout's one-time gathers of the
    working copies (``lay_out``) are not a step's. Both kinds run the compute
    split's collectives (:func:`_split_layer`: a prefill whose S |model|
    divides on the sequence-parallel residual, ``gather_seq`` and
    ``scatter_seq``; decode's sums, ``sum_partials``), the vocabulary
    split's (:func:`_vocab_ops`: the embedding's sum, a prefill's last row,
    the logits' gather) and the MoE dispatches; a decode step also gathers
    the cache leaves that a family computing whole over ``model`` holds
    split (``gather_cache``), and runs
    the KV-partition slot of each layer that attends through it (heads: a
    whole-compute family's ``all_gather`` of the output, nothing for a split
    model's heads; sequence: the flash-decode combine's ``all_reduce_max``
    and ``all_reduce``, also for the hybrid's rings where their slots are
    split)."""
    from repro_torch import tree as T
    from repro_torch.models import registry
    from repro_torch.models.pshard import model_split
    from repro_torch.models.sharding import NamedSharding, batch_axes, kv_partition_mode
    from repro_torch.serving.steps import KV_LEAVES, cache_shardings

    out = _Sent()
    b_axes = batch_axes(mesh)
    n_rows = math.prod(mesh.shape[a] for a in b_axes)
    dealt = shape.global_batch % n_rows == 0
    rows = shape.global_batch // n_rows if dealt else shape.global_batch
    batch_split = n_rows if dealt and cfg.family == "moe" else 1
    m = mesh.shape.get("model", 1)
    mode = kv_partition_mode(cfg, mesh, sh) if cfg.family != "ssm" else None
    split = model_split(cfg, mesh, mode)
    if shape.kind not in ("prefill", "decode"):
        raise ValueError(f"serve_collectives takes prefill or decode, not {shape.kind!r}")
    S = shape.seq_len if shape.kind == "prefill" else 1
    if split is not None:
        split = split.at(S)
        for _ in range(cfg.num_layers):
            _split_layer(out, cfg, split, rows, S)
        if split.vocab is not None:
            for fwd, _bwd in _vocab_ops(cfg, split, rows, S, train=False):
                _issue(out, fwd, m)
    if cfg.family == "moe":
        for _ in range(cfg.num_layers):
            _moe_layer(out, cfg, mesh, rows, S, batch_split)
    if shape.kind == "prefill":
        return out
    cache = registry.cache_shapes(cfg, shape)
    specs = cache_shardings(cache, cfg, mesh, sh)
    slot_layers = 0
    for (path, leaf), spec in zip(T.flatten_with_paths(cache), T.leaves(specs)):
        if not hasattr(leaf, "shape"):
            continue
        sharding = NamedSharding(mesh, spec)
        behind_slot = (cfg.family != "ssm" and path[-1] in KV_LEAVES
                       and (cfg.family != "hybrid" or int(path[1]) in cfg.global_layers
                            or (split is not None
                                and any(a == "model" for _, a in sharding.splits(4)))))
        if behind_slot:
            slot_layers += (leaf.shape[0] if leaf.dim() == 5 else 1) if path[-1] == "k" else 0
            continue
        if split is not None:  # a split model's leaves stay its slices
            continue
        cur = local_numel(sharding, tuple(leaf.shape)) * leaf.element_size()
        for _dim, axis in reversed(sharding.splits(leaf.dim())):
            if axis not in BATCH_AXES:
                out.all_gather("gather_cache", axis, mesh.shape[axis], cur)
                cur *= mesh.shape[axis]
    if cfg.family != "ssm" and m > 1:
        H, hd = cfg.num_heads, cfg.head_dim_
        for _ in range(slot_layers):
            if mode == "sequence":
                out.all_reduce("all_reduce_max", "model", m, rows * H * F32)
                out.all_reduce("all_reduce", "model", m, rows * H * (hd + 1) * F32)
            elif split is None:
                out.all_gather("all_gather", "model", m, rows * H // m * hd * BF16)
    return out


def step_collectives(cfg: ModelConfig, shape: ShapeConfig, mesh, *,
                     sh: ShardingConfig = ShardingConfig(), transport: str = "xla",
                     tcfg: TrainConfig = TrainConfig(), model=None) -> Counter:
    """Bytes one rank sends in one step of the cell, by ``op@axis``: a train
    step (:func:`train_collectives`, of ``model`` or a meta model of
    ``cfg``) or a serve step (:func:`serve_collectives`)."""
    if shape.kind == "train":
        if model is None:
            from repro_torch.models import registry

            model = registry.build(cfg, device="meta")
        return train_collectives(model, mesh, sh, transport=transport, tcfg=tcfg, shape=shape)
    return serve_collectives(cfg, shape, mesh, sh)
