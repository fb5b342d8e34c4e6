"""Mixture-of-Experts transformer (qwen3-moe, dbrx): the serving path.

The counterpart of ``src/repro/models/moe.py``. Each layer is the dense
layer with its MLP replaced by a bank of experts behind a top-k router. The
expert-dispatch layer is a Select (``cfg.moe.dispatch``, negotiated by
``comm/moe_dispatch.py``):

  dense      every expert for every token, weighted: the oracle, tiny
             configs only
  grouped    capacity-based gather, batched expert SwiGLU, scatter combine
  alltoall   expert-parallel over the mesh's ``model`` axis: with no mesh the
  allgather  reference resolves both to ``grouped`` (``moe_ffn``), and so does
             the port; on a mesh with a ``model`` axis they raise
             ``NotImplementedError`` (ROADMAP §A item 7b)

All share the routing (``route``) and ``capacity``. The expert products are
``torch.bmm``/``torch.einsum`` in bfloat16, as the reference leaves its
einsums to XLA; no kernel of the TPU package sits on this path. The
load-balance aux loss is computed and dropped in serving, as in the
reference.

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

import math

import torch
from torch import nn
from torch.nn import functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import COMPUTE, Linear, Norm, activation, truncated_normal_
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


def _gather_scatter_ffn(p: MoeMLP, x2d: torch.Tensor, gates, ids, cfg: ModelConfig, C: int):
    """Capacity gather -> expert ffn -> scatter combine. x2d ``(T, D)``."""
    Tn, D = x2d.shape
    E = cfg.moe.num_experts
    pos, keep = _positions_in_expert(ids, E, C)
    tok_idx = torch.arange(Tn, device=x2d.device)[:, None].expand_as(ids)
    # sentinel row T gathers zeros for empty slots
    x_pad = torch.cat([x2d, x2d.new_zeros(1, D)], dim=0)
    slot_tok = torch.full((E, C), Tn, dtype=torch.long, device=x2d.device)
    kept = keep.reshape(-1)
    slot_tok.index_put_((ids.reshape(-1)[kept], pos.reshape(-1)[kept]),
                        tok_idx.reshape(-1)[kept])
    y_sorted = expert_ffn(p.banks(), x_pad[slot_tok], cfg)  # (E, C, D)
    y_tk = y_sorted[ids, pos.clamp(max=C - 1)]  # (T, k, D); dropped slots weigh 0
    w = (gates * keep).float()
    return torch.einsum("tkd,tk->td", y_tk.float(), w).to(x2d.dtype)


def dispatch_grouped(p: MoeMLP, x2d: torch.Tensor, cfg: ModelConfig):
    """Capacity dispatch on one device."""
    gates, ids, aux = route(p.router.w, x2d, cfg)
    C = capacity(x2d.shape[0], cfg)
    return _gather_scatter_ffn(p, x2d, gates, ids, cfg, C), aux


def moe_ffn(p: MoeMLP, x3d: torch.Tensor, cfg: ModelConfig, mesh=None):
    """The dispatch Select's resolution: x3d ``(B, S, D)`` -> (``(B, S, D)``,
    aux). ``alltoall`` and ``allgather`` resolve to ``grouped`` without a
    mesh that has a ``model`` axis, as the reference's do; with one they
    raise."""
    impl = cfg.moe.dispatch
    if impl not in DISPATCHES:
        raise ValueError(f"unknown moe dispatch {impl!r}")
    axes = tuple(getattr(mesh, "axis_names", ())) if mesh is not None else ()
    if impl in ("alltoall", "allgather") and "model" in axes:
        raise NotImplementedError(
            f"the {impl} expert-parallel dispatch over torch.distributed is not ported "
            "(ROADMAP §A item 7b); serve on one device, or negotiate grouped")
    B, S, D = x3d.shape
    x2d = x3d.reshape(B * S, D)
    fn = dispatch_dense if impl == "dense" else dispatch_grouped
    y, aux = fn(p, x2d, cfg)
    return y.reshape(B, S, D), aux


# ---------------------------------------------------------------------------
# Model
# ---------------------------------------------------------------------------


class MoeLM(DenseLM):
    """The moe family's model: ``DenseLM``'s embedding, attention, cache,
    prefill and decode, with each layer's MLP replaced by ``moe_ffn``."""

    FAMILY, LAYER = "moe", MoeLayer

    def _ffn(self, layer: MoeLayer, h: torch.Tensor) -> torch.Tensor:
        y, _aux = moe_ffn(layer.moe, layer.ln2(h), self.cfg)
        return y
