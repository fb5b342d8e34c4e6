"""Mixture-of-Experts transformer (qwen3-moe, dbrx).

The counterpart of ``src/repro/models/moe.py``. Each layer is the dense
layer with its MLP replaced by a bank of experts behind a top-k router. The
expert-dispatch layer is a Select (``cfg.moe.dispatch``, negotiated by
``comm/moe_dispatch.py``):

  dense      every expert for every token, weighted: the oracle, tiny
             configs only
  grouped    capacity-based gather, batched expert SwiGLU, scatter combine
  alltoall   expert-parallel over the mesh's ``model`` axis: each rank
             routes its slice of tokens, all-to-alls the capacity buffers
             to the experts' owners, runs its E/|model| experts and
             all-to-alls the outputs back
  allgather  each rank runs its E/|model| experts for its data row's tokens
             (all-gathered over ``model``), the partial outputs summed

``alltoall`` and ``allgather`` run on a mesh with a ``data`` and a ``model``
axis whose sizes divide the global batch, the sequence and the experts
(:func:`mesh_dispatch`, the reference's conditions at ``moe.py:317-329``);
anywhere else they resolve to ``grouped``, as the reference's do (decode,
with one token a row, always). On a mesh, ``moe_ffn`` is given this rank's
rows of the global batch (``batch_split`` blocks of rows dealt over ``pod``
and ``data``, 1 where every rank holds them all; the caller passes it).
Under the compute split's sequence-parallel residual (``pshard.Split.seq``,
the moe family's layout since the split covers it) the rows arrive as the
rank's ``S/|model|`` positions, the reference's in-spec ``P(b_axes,
"model", None)``: the mesh dispatches route them with the capacity of the
rank's own tokens, run the rank's ``E/|model|`` experts and hand back the
rank's positions (``alltoall`` after its second all-to-all; ``allgather``
by a reduce-scatter of the partial outputs, the reference's out-spec), and
``grouped`` and ``dense`` read the rows gathered over S and keep their own
positions. Without it (the residual whole: S that |model| does not divide,
or no split) each rank computes the whole forward on its rows: the mesh
dispatches take the rank's slice of the sequence and hand the output back
all-gathered over ``model``. ``grouped`` and ``dense`` on dealt rows route
the global batch (its rows all-gathered), as the reference's global
computation does. The load-balance aux loss is averaged over ``model``,
then ``data``, as in the reference. In training under a mesh dispatch the
split reads the expert banks as the rank's ``model`` block (``Split.experts``:
gathered over the batch axes only). In serving, wherever |model| divides E,
the split reads them so too: a rank's bfloat16 serving banks hold its
``E/|model|`` experts only, as the reference keeps its banks sharded over
``model`` and gathers them over ``data`` alone (``_gathered_weights``). The
mesh dispatches then take those banks as they are, and ``grouped`` (decode
always, a prefill wherever no mesh dispatch runs) becomes expert-parallel
(:func:`dispatch_grouped_ep`): every rank of ``model`` routes the same
tokens over all E experts at the same capacity, so that the drops are the
whole-bank dispatch's, runs its own experts' capacity slots, combines its
own experts' (token, slot) pairs into a float32 partial, and the partials
are summed over ``model`` once (``sum_partials``), then rounded.

All share the routing (``route``) and ``capacity``. The expert products are
``torch.bmm``/``torch.einsum`` in bfloat16, as the reference leaves its
einsums to XLA; no kernel of the TPU package sits on this path. The
load-balance aux loss is computed and dropped in serving, as in the
reference; training (``MoeLM.loss``) adds it to the LM loss.

Training differentiates every dispatch. The index arithmetic carries no
gradient (expert ids, positions, slots); the gradient flows through the
gate values (``topk``'s backward), the gathered capacity buffers (a dropped
or empty slot reads the zero row and gives nothing back) and the combine
(``gates * keep`` zeroes a dropped pair's). The mesh dispatches follow the
reference's ``shard_map`` transposes on the port's compute model, through
``comm.collectives``' differentiable collectives: an all-to-all's backward
is the all-to-all of the cotangent; the output gathered over ``model``
feeds every rank's repeated forward (backward: the rank's block), the rows
gathered for ``allgather``'s and the dealt ``grouped``'s experts feed each
rank's own part (backward: a reduce-scatter sum); the partial outputs'
sum feeds a repeated forward (backward: the cotangent as it is), or is
reduce-scattered to the rank's positions (backward: an all-gather). The
router, the rows before their sequence slice and the banks before their
expert slice enter the dispatch whole on every rank of ``model``, and
their backward sums the ranks' gradients over it (``_router``,
``_seq_slice``, ``_local_banks``), as ``shard_map`` sums an input's
cotangent over the axes its spec does not name; without it every rank
would keep its own tokens' or experts' share of the gradient only. Under
the sequence-parallel residual the rows arrive as the rank's positions and
the banks as its experts, so only the router's sum remains. ``grouped`` on
the rows gathered over S computes the aux whole on every rank of
``model``, while each rank's LM loss reads its own positions: the aux
passes only 1/|model| of its gradient (``_aux_once``), so that the sums
over ``model`` of the router's and the rows' gradients count it once.

Three of the reference's semantics that PyTorch does not give for free:

- ``torch.topk(..., sorted=True)`` for ``lax.top_k``: slot 0 is the largest
  gate; it feeds the aux loss and the token-major, slot-minor capacity
  priority.
- The scatter of kept slots (``slot_tok.at[ids, pos].set(..., mode="drop")``
  in the reference) is an ``index_put_`` over the kept entries only: a
  dropped slot has ``pos >= C``, out of range.
- The combine's gather ``y_sorted[ids, pos]`` reads dropped slots at
  ``pos >= C``; JAX clamps an out-of-range gather index and the gate weight
  ``gates * keep`` zeroes the result. A PyTorch index out of range raises on
  the CPU and device-asserts on the card, so ``pos`` is clamped to C - 1.

The cache and decode attention are the dense family's (``DenseLM``).
"""
from __future__ import annotations

import functools
import math

import torch
from torch import nn
from torch.nn import functional as F

from repro_torch.comm import collectives
from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import COMPUTE, Linear, Norm, activation, truncated_normal_
from repro_torch.models.sharding import batch_axes
from repro_torch.models.transformer import Attention, DenseLM

AUX_LOSS_COEF = 0.01
#: the dispatch impls of the Select
DISPATCHES = ("dense", "grouped", "alltoall", "allgather")


class MoeMLP(nn.Module):
    """The router ``router.w`` ``(D, E)`` and the expert banks ``gate``,
    ``up`` ``(E, D, F)`` and ``down`` ``(E, F, D)``, float32, with bfloat16
    serving copies made by :meth:`prepare` (the reference casts the banks at
    every call)."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        m = cfg.moe
        E, D, Fe = m.num_experts, cfg.d_model, m.d_ff_expert
        self.router = Linear(D, E, device=device)
        self.router.reads_f32 = True  # ``route`` multiplies the float32 weight
        self.gate = nn.Parameter(torch.empty((E, D, Fe), device=device))
        self.up = nn.Parameter(torch.empty((E, D, Fe), device=device))
        self.down = nn.Parameter(torch.empty((E, Fe, D), device=device))
        for name in ("gate16", "up16", "down16"):
            self.register_buffer(name, None, persistent=False)

    def init(self, gen: torch.Generator) -> None:
        D, Fe = self.gate.shape[1], self.gate.shape[2]
        self.router.init(gen)
        truncated_normal_(self.gate, D**-0.5, gen)
        truncated_normal_(self.up, D**-0.5, gen)
        truncated_normal_(self.down, Fe**-0.5, gen)

    def prepare(self) -> None:
        for name in ("gate", "up", "down"):
            setattr(self, f"{name}16", getattr(self, name).detach().to(COMPUTE))

    def release(self) -> None:
        self.gate16 = self.up16 = self.down16 = None

    def banks(self):
        """The bfloat16 ``gate``, ``up`` and ``down`` banks."""
        if self.gate16 is None:
            return tuple(getattr(self, n).to(COMPUTE) for n in ("gate", "up", "down"))
        return self.gate16, self.up16, self.down16


class MoeLayer(nn.Module):
    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.ln1 = Norm(cfg.d_model, cfg.norm, cfg.norm_eps, device=device)
        self.attn = Attention(cfg, device=device)
        self.ln2 = Norm(cfg.d_model, cfg.norm, cfg.norm_eps, device=device)
        self.moe = MoeMLP(cfg, device=device)

    def init(self, gen: torch.Generator) -> None:
        self.ln1.init()
        self.attn.init(gen)
        self.ln2.init()
        self.moe.init(gen)


# ---------------------------------------------------------------------------
# Routing (shared by all dispatch impls)
# ---------------------------------------------------------------------------


def capacity(num_tokens: int, cfg: ModelConfig) -> int:
    m = cfg.moe
    return max(1, int(math.ceil(num_tokens * m.top_k * m.capacity_factor / m.num_experts)))


def route(router_w: torch.Tensor, x2d: torch.Tensor, cfg: ModelConfig):
    """x2d ``(T, D)``. Returns (gates ``(T, k)`` float32, expert ids ``(T, k)``
    int64, aux loss): the top-k of the float32 softmax, slot 0 the largest,
    renormalised over the k."""
    m = cfg.moe
    probs = torch.softmax(x2d.float() @ router_w.float(), dim=-1)
    gate_vals, expert_ids = torch.topk(probs, m.top_k, dim=-1, sorted=True)
    gate_vals = gate_vals / gate_vals.sum(dim=-1, keepdim=True).clamp_min(1e-9)
    # Switch-style load-balance loss: E * sum_e fraction_e * router_prob_e
    frac = F.one_hot(expert_ids[:, 0], m.num_experts).float().mean(dim=0)
    aux = m.num_experts * torch.sum(frac * probs.mean(dim=0)) * AUX_LOSS_COEF
    return gate_vals, expert_ids, aux


def _positions_in_expert(expert_ids: torch.Tensor, E: int, C: int):
    """Capacity assignment. expert_ids ``(T, k)`` -> pos ``(T, k)`` (the
    place in its expert's queue, token-major, slot-minor) and keep ``pos < C``."""
    Tn, k = expert_ids.shape
    # (E, T*k): each expert's queue a row, so that the running count is a
    # scan along the inner dim (a scan along the outer dim of (T*k, E) runs
    # each column's count in one thread on the card)
    onehot = F.one_hot(expert_ids.reshape(-1), E).T
    pos = ((onehot.cumsum(dim=1) - 1) * onehot).sum(dim=0).reshape(Tn, k)
    return pos, pos < C


def expert_ffn(banks, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Batched expert SwiGLU in bfloat16: x ``(E, C, D)`` -> ``(E, C, D)``."""
    gate, up, down = banks
    x = x.to(COMPUTE)
    a = activation(torch.bmm(x, gate), cfg.act)
    return torch.bmm(a * torch.bmm(x, up), down)


# ---------------------------------------------------------------------------
# Dispatch impls
# ---------------------------------------------------------------------------


def dispatch_dense(p: MoeMLP, x2d: torch.Tensor, cfg: ModelConfig):
    """The oracle: every expert for every token (tiny configs only)."""
    gates, ids, aux = route(p.router.w, x2d, cfg)
    gate, up, down = p.banks()
    x = x2d.to(COMPUTE)
    g = torch.einsum("td,edf->tef", x, gate)
    u = torch.einsum("td,edf->tef", x, up)
    y_all = torch.einsum("tef,efd->ted", activation(g, cfg.act) * u, down)  # (T, E, D)
    dense_gates = (F.one_hot(ids, cfg.moe.num_experts).float() * gates[..., None]).sum(dim=1)
    y = torch.einsum("ted,te->td", y_all.float(), dense_gates)
    return y.to(x2d.dtype), aux


def _slot_tokens(ids, pos, keep, n_experts: int, C: int, sentinel: int) -> torch.Tensor:
    """(n_experts, C): the token in each capacity slot, ``sentinel`` (a zero
    row) where empty; only the kept (token, slot) pairs land in a slot, the
    dropped ones in one spare slot past the end. No index depends on the
    data's values, so the dispatch also runs on meta tensors
    (``launch.dryrun``)."""
    tok_idx = torch.arange(ids.shape[0], device=ids.device)[:, None].expand_as(ids)
    slot_tok = torch.full((n_experts * C + 1,), sentinel, dtype=torch.long, device=ids.device)
    dest = torch.where(keep, ids * C + pos, n_experts * C)
    slot_tok.index_put_((dest.reshape(-1),), tok_idx.reshape(-1))
    return slot_tok[:-1].view(n_experts, C)


def _combine(y_sorted, ids, pos, gates, keep, C: int) -> torch.Tensor:
    """(T, D) float32: each token's kept slots' expert outputs, weighted by
    their gates; dropped slots read a clamped position and weigh 0."""
    y_tk = y_sorted[ids, pos.clamp(max=C - 1)]  # (T, k, D)
    return torch.einsum("tkd,tk->td", y_tk.float(), (gates * keep).float())


def _sorted_tokens(x2d, slot_tok) -> torch.Tensor:
    """The capacity buffers ``x2d[slot_tok]``, empty slots gathering zeros."""
    return torch.cat([x2d, x2d.new_zeros(1, x2d.shape[1])], dim=0)[slot_tok]


def _gather_scatter_ffn(p: MoeMLP, x2d: torch.Tensor, gates, ids, cfg: ModelConfig, C: int):
    """Capacity gather -> expert ffn -> scatter combine. x2d ``(T, D)``."""
    E = cfg.moe.num_experts
    pos, keep = _positions_in_expert(ids, E, C)
    slot_tok = _slot_tokens(ids, pos, keep, E, C, x2d.shape[0])
    y_sorted = expert_ffn(p.banks(), _sorted_tokens(x2d, slot_tok), cfg)  # (E, C, D)
    return _combine(y_sorted, ids, pos, gates, keep, C).to(x2d.dtype)


def dispatch_grouped(p: MoeMLP, x2d: torch.Tensor, cfg: ModelConfig):
    """Capacity dispatch on one device."""
    gates, ids, aux = route(p.router.w, x2d, cfg)
    C = capacity(x2d.shape[0], cfg)
    return _gather_scatter_ffn(p, x2d, gates, ids, cfg, C), aux


def _own_experts_partial(banks, x2d: torch.Tensor, gates, ids, cfg: ModelConfig, C: int,
                         r: int, e_loc: int) -> torch.Tensor:
    """(T, D) float32: the combine of the (token, slot) pairs kept for the
    experts ``[r·e_loc, (r+1)·e_loc)`` that ``banks`` hold, the capacity
    ``C`` assigned over all E experts (the other pairs weigh 0)."""
    pos, keep = _positions_in_expert(ids, cfg.moe.num_experts, C)
    keep_loc = keep & ((ids // e_loc) == r)
    ids_loc = torch.where(keep_loc, ids - r * e_loc, 0)
    x_sorted = _sorted_tokens(x2d, _slot_tokens(ids_loc, pos, keep_loc, e_loc, C, x2d.shape[0]))
    return _combine(expert_ffn(banks, x_sorted, cfg), ids_loc, pos, gates, keep_loc, C)


def dispatch_grouped_ep(p: MoeMLP, x2d: torch.Tensor, cfg: ModelConfig, mesh,
                        axis: str = "model"):
    """``dispatch_grouped`` on the rank's ``E/|axis|`` experts (``p``'s
    banks hold them only), for serving: the same tokens routed on every rank
    of ``axis`` over all E experts at the capacity of all of them, the
    rank's experts' slots computed and its (token, slot) pairs combined into
    a float32 partial, the partials summed over ``axis`` and rounded once.
    x2d ``(T, D)``; returns (``(T, D)``, aux)."""
    n, r = mesh.shape[axis], mesh.coords[axis]
    E = cfg.moe.num_experts
    e_loc = E // n
    if E % n or p.banks()[0].shape[0] != e_loc:
        raise ValueError(f"the rank's banks hold {p.banks()[0].shape[0]} experts; "
                         f"{E} experts over {n} ranks")
    gates, ids, aux = route(p.router.w, x2d, cfg)
    y_part = _own_experts_partial(p.banks(), x2d, gates, ids, cfg,
                                  capacity(x2d.shape[0], cfg), r, e_loc)
    return collectives.sum_partials(y_part, mesh, axis, x2d.dtype), aux


def _local_banks(p: MoeMLP, mesh, axis: str):
    """This rank's E/|axis| experts of the bfloat16 banks, whole in d_model
    (the reference's ``_gathered_weights``). The banks enter the dispatch
    whole on every rank of ``axis``: the backward all-gathers the ranks'
    experts' gradients (``collectives.replicated_block``)."""
    return tuple(collectives.replicated_block(w, mesh, axis, 0) for w in p.banks())


def _router(p: MoeMLP, mesh, axis: str) -> torch.Tensor:
    """The router weight, whole on every rank of ``axis``: its backward sums
    the ranks' gradients, each from its own tokens or experts
    (``collectives.replicated``)."""
    return collectives.replicated(p.router.w, mesh, axis)


def _mean_aux(aux: torch.Tensor, mesh, axis: str, data_axis: str) -> torch.Tensor:
    """``pmean(pmean(aux, axis), data_axis)``. The mean feeds every rank's
    loss: over ``axis`` the ranks repeat one loss (the backward passes the
    cotangent), over ``data_axis`` each holds its rows' (the cotangents
    sum), so that after the step's mean over the batch axes each rank's
    aux weighs ``1 / (|axis| |data_axis|)``, as in the reference."""
    for a, downstream in ((axis, "replicated"), (data_axis, "partial")):
        aux = collectives.all_reduce_grad(aux.reshape(1), mesh, a,
                                          downstream=downstream)[0] / mesh.shape[a]
    return aux


def _seq_slice(x3d: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """This rank's S/|axis| positions of its rows, flattened: (B_l*S_l, D).
    The rows enter whole on every rank of ``axis``: the backward all-gathers
    the ranks' slices' gradients (``collectives.replicated_block``)."""
    x_loc = collectives.replicated_block(x3d, mesh, axis, 1)
    return x_loc.reshape(-1, x3d.shape[2])


def dispatch_alltoall(p: MoeMLP, x3d: torch.Tensor, cfg: ModelConfig, mesh,
                      axis: str = "model", data_axis: str = "data", *,
                      positions: bool = False, experts: bool = False):
    """Explicit expert-parallel all-to-all over ``axis``.

    x3d ``(B_l, S, D)`` is this rank's rows (``positions``: its ``(B_l,
    S/n, D)`` positions of them, the sequence-parallel residual). The rank
    routes its S/n slice with the capacity of its own tokens, all-to-alls
    the ``(n, E/n, C, D)`` capacity buffers to the experts' owners, computes
    its E/n experts (``experts``: ``p``'s banks are the rank's experts
    already), all-to-alls the outputs back and combines them; the output is
    the rank's positions, or with the whole rows all-gathered over ``axis``
    into their whole sequence. Returns (``(B_l, S or S/n, D)``, aux)."""
    n = mesh.shape[axis]
    E = cfg.moe.num_experts
    if E % n:
        raise ValueError(f"{E} experts over {n} ranks")
    B_l, S, D = x3d.shape
    x_loc = x3d.reshape(-1, D) if positions else _seq_slice(x3d, mesh, axis)
    banks = p.banks() if experts else _local_banks(p, mesh, axis)
    gates, ids, aux = route(_router(p, mesh, axis), x_loc, cfg)
    C = capacity(x_loc.shape[0], cfg)
    pos, keep = _positions_in_expert(ids, E, C)
    x_sorted = _sorted_tokens(x_loc, _slot_tokens(ids, pos, keep, E, C, x_loc.shape[0]))
    # (n, E_loc, C, D) --a2a--> indexed by source rank
    x_recv = collectives.all_to_all_grad(x_sorted.to(COMPUTE).reshape(n, E // n, C, D), mesh,
                                         axis)
    x_pe = x_recv.transpose(0, 1).reshape(E // n, n * C, D)
    y_pe = expert_ffn(banks, x_pe, cfg)
    y_send = y_pe.reshape(E // n, n, C, D).transpose(0, 1).contiguous()
    y_sorted = collectives.all_to_all_grad(y_send, mesh, axis).reshape(E, C, D)  # rank's slots
    y_loc = _combine(y_sorted, ids, pos, gates, keep, C).to(x3d.dtype)
    if positions:
        return y_loc.reshape(B_l, S, D), _mean_aux(aux, mesh, axis, data_axis)
    # every rank of the axis goes on with the whole sequence of its rows
    y = collectives.gather_grad(y_loc.reshape(B_l, S // n, D), mesh, axis, 1,
                                downstream="replicated")
    return y, _mean_aux(aux, mesh, axis, data_axis)


def dispatch_allgather(p: MoeMLP, x3d: torch.Tensor, cfg: ModelConfig, mesh,
                       axis: str = "model", data_axis: str = "data", *,
                       positions: bool = False, experts: bool = False):
    """Each model-rank computes its local experts for its data row's
    tokens: the rank's S/n slice (``positions``: ``x3d`` is its positions
    already) is all-gathered over ``axis`` (bfloat16), routed with the
    capacity of the row's tokens, and the partial outputs summed over
    ``axis``: reduce-scattered to the rank's positions (the reference's
    out-spec) with ``positions``, else all-reduced into the row's whole
    output (the port's layout of whole rows). ``experts`` as for
    :func:`dispatch_alltoall`. Returns (``(B_l, S or S/n, D)``, aux)."""
    n, r = mesh.shape[axis], mesh.coords[axis]
    E = cfg.moe.num_experts
    if E % n:
        raise ValueError(f"{E} experts over {n} ranks")
    e_loc = E // n
    B_l, S, D = x3d.shape
    x_loc = x3d.reshape(-1, D) if positions else _seq_slice(x3d, mesh, axis)
    banks = p.banks() if experts else _local_banks(p, mesh, axis)
    # (n*T_loc, D); each rank runs its own experts on it: the backward sums
    x_row = collectives.gather_grad(x_loc.to(COMPUTE), mesh, axis, 0, downstream="partial")
    gates, ids, aux = route(_router(p, mesh, axis), x_row.float(), cfg)
    y_part = _own_experts_partial(banks, x_row, gates, ids, cfg, capacity(x_row.shape[0], cfg),
                                  r, e_loc)
    if positions:  # rows of x_row are (model rank, token): this rank's are block r
        y = collectives.scatter_seq(y_part[None], mesh, axis, x3d.dtype, op="reduce_scatter")
        return y.reshape(B_l, S, D), _mean_aux(aux, mesh, axis, data_axis)
    y_row = collectives.all_reduce_grad(y_part, mesh, axis, downstream="replicated")
    # rows of x_row are (model rank, row, position in the slice)
    y = y_row.reshape(n, B_l, S // n, D).transpose(0, 1).reshape(B_l, S, D)
    return y.to(x3d.dtype), _mean_aux(aux, mesh, axis, data_axis)


def mesh_dispatch(cfg: ModelConfig, mesh, rows: int, S: int, batch_split: int = 1):
    """The mesh dispatch (``"alltoall"`` or ``"allgather"``) that a
    ``moe_ffn`` call on ``rows`` rows of ``S`` positions (the whole
    sequence) runs on ``mesh``, or None where it resolves to ``grouped`` or
    ``dense``: the reference's conditions, a mesh with ``data`` and
    ``model`` axes, the global batch (``rows·batch_split``) divided by the
    batch axes and ``model`` dividing the sequence and the experts."""
    impl = cfg.moe.dispatch
    if impl not in ("alltoall", "allgather") or mesh is None:
        return None
    axes = tuple(mesh.axis_names)
    n_batch = math.prod(mesh.shape[a] for a in batch_axes(mesh))
    n_model = mesh.shape["model"] if "model" in axes else 1
    manual_ok = ("model" in axes and "data" in axes and (rows * batch_split) % n_batch == 0
                 and S % n_model == 0 and cfg.moe.num_experts % n_model == 0)
    return impl if manual_ok else None


def _aux_once(aux: torch.Tensor, m: int) -> torch.Tensor:
    """``aux``, computed whole on each of the ``m`` ranks of ``model`` from
    the rows gathered over S, passing 1/m of its gradient: the router's and
    the rows' gradients are summed over ``model`` (each rank's LM loss
    reads its own positions only), which then counts it once."""
    return aux.detach() + (aux - aux.detach()) / m


def moe_ffn(p: MoeMLP, x3d: torch.Tensor, cfg: ModelConfig, mesh=None, *,
            batch_split: int = 1, split=None):
    """The dispatch Select's resolution: x3d ``(B_l, S, D)`` -> (``(B_l, S,
    D)``, aux). On ``mesh`` x3d is this rank's rows: one of ``batch_split``
    blocks of the global batch dealt over ``pod`` and ``data`` (1: all of
    them); under ``split``'s ``seq`` (a ``pshard.Split``) their ``(B_l,
    S/|model|, D)`` positions, and the output is those positions too.
    ``alltoall`` and ``allgather`` run where :func:`mesh_dispatch` says;
    else they resolve to ``grouped``, as the reference's do: expert-parallel
    (:func:`dispatch_grouped_ep`) where ``split`` reads the banks as the
    rank's experts outside a mesh dispatch (serving)."""
    impl = cfg.moe.dispatch
    if impl not in DISPATCHES:
        raise ValueError(f"unknown moe dispatch {impl!r}")
    seq = split is not None and split.seq is not None
    experts = split is not None and split.experts
    B_l, S, D = x3d.shape
    S_all = S * mesh.shape["model"] if seq else S
    on_mesh = mesh_dispatch(cfg, mesh, B_l, S_all, batch_split)
    if on_mesh is not None:
        fn = dispatch_alltoall if on_mesh == "alltoall" else dispatch_allgather
        return fn(p, x3d, cfg, mesh, positions=seq, experts=experts)
    if seq:  # every position of the rank's rows; it keeps its own
        y, aux = moe_ffn(p, split.gather(x3d), cfg, mesh, batch_split=batch_split,
                         split=split.whole_seq())
        return split.own(y), _aux_once(aux, mesh.shape["model"])
    if impl == "dense":
        fn = dispatch_dense
    else:
        fn = functools.partial(dispatch_grouped_ep, mesh=mesh) if experts else dispatch_grouped
    if batch_split == 1:
        y, aux = fn(p, x3d.reshape(B_l * S, D), cfg)
        return y.reshape(B_l, S, D), aux
    # dealt rows: the global batch's tokens, routed together, as the
    # reference's global computation routes them; this rank keeps its rows
    x_all = x3d
    for a in reversed(batch_axes(mesh)):  # innermost first: rows in (pod, data) order
        x_all = collectives.gather_grad(x_all, mesh, a, 0, downstream="partial")
    y, aux = fn(p, x_all.reshape(-1, D), cfg)
    idx, _ = mesh.batch_index()
    return y.reshape(-1, S, D)[idx * B_l:(idx + 1) * B_l], aux


# ---------------------------------------------------------------------------
# Model
# ---------------------------------------------------------------------------


class MoeLM(DenseLM):
    """The moe family's model: ``DenseLM``'s embedding, attention, cache,
    prefill and decode, with each layer's MLP replaced by ``moe_ffn`` on the
    model's ``mesh``. Training (``hidden_states``, ``loss``) carries each
    layer's load-balance aux through the stack beside the residual stream,
    as the reference's ``moe_layer`` carry ``(x, aux_acc)``: an output of the
    layer's body, so that a layer recomputed in backward (``cfg.remat``)
    counts its aux once. On a mesh whose ``model`` axis has more than one
    rank it inherits ``DenseLM``'s compute split (``pshard.Split``: the
    attention's heads, the sequence-parallel residual, the vocabulary), and
    ``moe_ffn`` takes the split's layout of the rows."""

    FAMILY, LAYER = "moe", MoeLayer

    def _ffn(self, layer: MoeLayer, h: torch.Tensor, batch_split: int = 1,
             split=None) -> torch.Tensor:
        y, _aux = moe_ffn(layer.moe, layer.ln2(h), self.cfg, self.mesh,
                          batch_split=batch_split, split=split)
        return y

    def _train_moe_layer(self, layer: MoeLayer, carry: tuple, rope: tuple, split=None, *,
                         batch_split: int = 1):
        """The reference's ``moe_layer``: (x, aux_acc) -> (x', aux_acc + aux)."""
        x, aux_acc = carry
        h = self._attn_residual(layer, x, rope, split)
        y, aux = moe_ffn(layer.moe, layer.ln2(h), self.cfg, self.mesh, batch_split=batch_split,
                         split=split)
        return h + y, aux_acc + aux

    def hidden_states(self, tokens: torch.Tensor, *, batch_split: int = 1, split=None):
        """tokens (B, S) -> (final hidden states (B, S, D) bfloat16, the
        layers' summed aux loss): the reference's ``moe.hidden_states``.
        ``batch_split`` as for :meth:`prefill`: on a mesh, the rank's rows
        are one of ``batch_split`` blocks of the global batch. Under
        ``split``'s ``seq`` the hidden states are the rank's positions."""
        x = self._embed_inputs(tokens, None, split)
        zero = torch.zeros((), dtype=torch.float32, device=x.device)
        x, aux = self._train_stack(
            (x, zero), tokens.shape[1],
            lambda layer, c, rope, sp: self._train_moe_layer(layer, c, rope, sp,
                                                             batch_split=batch_split),
            split)
        return self.final_norm(x), aux

    def train_split(self, rows: int, S: int, batch_split: int = 1):
        """The training forward's split on ``rows`` rows of ``S`` positions:
        ``DenseLM``'s, reading the expert banks as the rank's ``model``
        block where the dispatch runs on the mesh (:func:`mesh_dispatch`)."""
        split = self._train_split(S)
        if split is not None and mesh_dispatch(self.cfg, split.mesh, rows, S, batch_split):
            split = split.with_experts()
        return split

    def loss(self, batch: dict, *, loss_chunk=None, batch_split: int = 1) -> torch.Tensor:
        """The reference's ``moe.loss_fn``: the LM loss of ``batch``
        (``tokens``, ``labels``) plus the aux."""
        self._check_released()
        tokens = batch["tokens"]
        split = self.train_split(tokens.shape[0], tokens.shape[1], batch_split)
        with self._head_gathered(split):
            h, aux = self.hidden_states(tokens, batch_split=batch_split, split=split)
            return self._lm_loss(h, batch["labels"], loss_chunk, split) + aux
