"""xLSTM LM (sLSTM + mLSTM blocks, arXiv:2405.04517).

The counterpart of ``src/repro/models/xlstm.py`` (family ``ssm``). Serving:
``prefill`` and ``decode_step`` over the recurrent state. Training:
``XlstmLM.loss(batch)`` (the reference's ``loss_fn``), the same ``forward``
with autograd on; no layer is rematerialised, as in the reference.

mLSTM: a matrix-memory cell, chunkwise parallel (the gated linear attention
form):
    C_t = f_t C_{t-1} + i_t v_t k_t^T ;  n_t = f_t n_{t-1} + i_t k_t
    h_t = (C_t q_t) / max(|n_t . q_t|, 1)
over chunks of ``min(chunk_size, S)`` positions (so decode runs chunk 1);
a ragged tail is padded with logf = 0, f = 1, which keeps the carry.
sLSTM: a scalar-memory cell with a true sequential recurrence, a loop over
time. The gates are bounded sigmoids, as in the reference (its numerics
note).

Layers differ (``is_slstm``): every ``slstm_every``-th is an sLSTM block, the
others mLSTM, so they are a list, named ``layers.{i}.<leaf>`` and never
stacked (``stacks()`` is empty), as the reference keeps them
(``init_params``: "heterogeneous: kept as a list"). There is no KV cache:
the state is ``{"layers": [{"C", "n"} | {"c", "n", "h"}, ...], "len"}``,
float32, and generation needs no growth. The gate products run in float32
(``Linear(..., dtype=torch.float32)``, the reference's
``L.linear(..., dtype=jnp.float32)``); the rest in bfloat16. This family
runs no kernel.

On a mesh whose ``model`` axis has more than one rank the model splits as
the reference's parameter specs lay it out (``pshard.Split``), each block by
its own divisibility. The embedding and the head are vocabulary-parallel
(``Split.vocab``): the rank's rows' lookups summed over ``model``, the loss
``layers.vocab_parallel_lm_loss`` of the rank's columns, the serving logits
gathered. The mLSTM runs the rank's H/|model| heads (``Split.heads``): its
input enters through the "f" (``Split.enter``), ``q``, ``k``, ``v``, the
gates and the state ``C`` (B, H/|model|, hd, hd), ``n`` (B, H/|model|, hd)
are the rank's heads', and ``wo`` is a row product whose float32 partials
are summed once (``Split.reduce``). The sLSTM runs the rank's D/|model|
channels (``Split.channels``): its gates' columns and ``r``'s, the state
``c``/``n``/``h`` (B, D/|model|) (the recurrence is elementwise over
channels), and the channels of its output all-gathered into the residual
(``Split.join``); its MLP splits by its width as the dense MLP does
(``Split.d_ff``). A block that |model| does not divide stays whole. The
reference pins the residual by batch only (``shard_batch``), so the split
has no ``seq``.
"""
from __future__ import annotations

from contextlib import nullcontext
from typing import Optional

import torch
from torch import nn
from torch.nn import functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import MLP, Linear, Norm, truncated_normal_
from repro_torch.models.pshard import Split
from repro_torch.models.transformer import DenseLM

F32 = torch.float32


def is_slstm(i: int, cfg: ModelConfig) -> bool:
    every = cfg.xlstm.slstm_every if cfg.xlstm else 2
    return (i % every) == every - 1


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------


class MLSTM(nn.Module):
    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        D, H, hd = cfg.d_model, cfg.num_heads, cfg.head_dim_
        self.ln = Norm(D, cfg.norm, cfg.norm_eps, device=device)
        self.wq = Linear(D, H * hd, device=device)
        self.wk = Linear(D, H * hd, device=device)
        self.wv = Linear(D, H * hd, device=device)
        self.wi = Linear(D, H, bias=True, device=device)
        self.wf = Linear(D, H, bias=True, device=device)
        self.wo_gate = Linear(D, H * hd, device=device)
        self.wo = Linear(H * hd, D, device=device)
        for lin in (self.wi, self.wf, self.wo_gate):  # the gates run in float32
            lin.reads_f32 = True

    def init(self, gen: torch.Generator) -> None:
        self.ln.init()
        for lin in (self.wq, self.wk, self.wv, self.wi, self.wf, self.wo_gate, self.wo):
            lin.init(gen)


def _mlstm_split(split: Optional[Split]) -> Optional[Split]:
    """``split`` where it splits the mLSTM by heads, else None (whole)."""
    return split if split is not None and split.heads is not None else None


def _slstm_split(split: Optional[Split]) -> Optional[Split]:
    """``split`` where it splits the sLSTM's gates by channels, else None."""
    return split if split is not None and split.channels is not None else None


def mlstm_state(batch: int, cfg: ModelConfig, device=None, split: Optional[Split] = None) -> dict:
    """The zero state of an mLSTM block: every head, or the rank's under
    ``split``."""
    sp, hd = _mlstm_split(split), cfg.head_dim_
    H = cfg.num_heads if sp is None else sp.heads.q.stop - sp.heads.q.start
    return {"C": torch.zeros((batch, H, hd, hd), dtype=F32, device=device),
            "n": torch.zeros((batch, H, hd), dtype=F32, device=device)}


def _mlstm_chunk(q, k, v, i, logf, C0, n0):
    """One chunk of the chunkwise-parallel mLSTM.

    q, k, v ``(B, C, H, hd)``; i ``(B, C, H)`` the input gate in [0, 1]; logf
    ``(B, C, H)`` <= 0; C0 ``(B, H, hd, hd)``; n0 ``(B, H, hd)``. Returns
    (h ``(B, C, H, hd)``, C1, n1), all float32."""
    Cn, hd = q.shape[1], q.shape[3]
    q = q.float() * hd**-0.5
    k, v = k.float(), v.float()
    Fc = torch.cumsum(logf, dim=1)  # (B, C, H) cumulative log-forget within the chunk
    # intra-chunk: D[j, u] = exp(F_j - F_u) * i_u for u <= j
    Dmat = torch.exp(Fc[:, :, None, :] - Fc[:, None, :, :])  # (B, j, u, H)
    causal = torch.ones(Cn, Cn, dtype=torch.bool, device=q.device).tril()
    Dmat = torch.where(causal[None, :, :, None], Dmat * i[:, None, :, :],
                       torch.zeros((), dtype=F32, device=q.device))
    sv = torch.einsum("bjhd,buhd->bjuh", q, k) * Dmat
    h_intra = torch.einsum("bjuh,buhd->bjhd", sv, v)
    # inter-chunk: the carry C0, n0 decayed to each position
    decay = torch.exp(Fc)  # (B, C, H)
    h_inter = torch.einsum("bjh,bhde,bjhd->bjhe", decay, C0, q)
    n_inter = torch.einsum("bjh,bhd,bjhd->bjh", decay, n0, q)
    # the normaliser: n_j . q_j = sum_u D[j, u] (k_u . q_j)
    denom = torch.clamp_min(torch.abs(sv.sum(dim=2) + n_inter), 1.0)
    h = (h_intra + h_inter) / denom[..., None]
    # carry updates
    last = torch.exp(Fc[:, -1])  # (B, H)
    w_u = torch.exp(Fc[:, -1:, :] - Fc) * i  # (B, C, H): decay from u to the chunk's end
    C1 = last[:, :, None, None] * C0 + torch.einsum("buh,buhd,buhe->bhde", w_u, k, v)
    n1 = last[:, :, None] * n0 + torch.einsum("buh,buhd->bhd", w_u, k)
    return h, C1, n1


def mlstm_apply(p: MLSTM, x: torch.Tensor, cfg: ModelConfig, state: Optional[dict] = None, *,
                chunk: Optional[int] = None, split: Optional[Split] = None):
    """x ``(B, S, D)`` -> (x + the block's output, new state). Under
    ``split``'s heads, ``p``'s products are the rank's blocks and the state
    its heads'; ``wo``'s partial outputs are summed over ``model``."""
    B, S, _ = x.shape
    sp = _mlstm_split(split)
    hd = cfg.head_dim_
    chunk = min(chunk or (cfg.xlstm.chunk_size if cfg.xlstm else 64), S)
    state = state if state is not None else mlstm_state(B, cfg, x.device, sp)

    xn = p.ln(x) if sp is None else sp.enter(p.ln(x))
    q = p.wq(xn).reshape(B, S, -1, hd)
    H = q.shape[2]
    k = p.wk(xn).reshape(B, S, H, hd)
    v = p.wv(xn).reshape(B, S, H, hd)
    i = torch.sigmoid(p.wi(xn, dtype=F32))
    logf = F.logsigmoid(p.wf(xn, dtype=F32))
    pad = (-S) % chunk
    if pad:  # zeros; logf = 0 (f = 1) keeps the carry through the padding
        q, k, v = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (q, k, v))
        i, logf = (F.pad(t, (0, 0, 0, pad)) for t in (i, logf))
    C, n = state["C"], state["n"]
    hs = []
    for c0 in range(0, S + pad, chunk):
        sl = slice(c0, c0 + chunk)
        h, C, n = _mlstm_chunk(q[:, sl], k[:, sl], v[:, sl], i[:, sl], logf[:, sl], C, n)
        hs.append(h)
    h = torch.cat(hs, dim=1)[:, :S]
    o = torch.sigmoid(p.wo_gate(xn, dtype=F32)).reshape(B, S, H, hd)
    y = (h * o).to(x.dtype).reshape(B, S, H * hd)
    out = p.wo(y) if sp is None else sp.reduce(p.wo.partial(y))
    return x + out, {"C": C, "n": n}


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------


class SLSTM(nn.Module):
    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        D = cfg.d_model
        self.ln = Norm(D, cfg.norm, cfg.norm_eps, device=device)
        self.wz = Linear(D, D, bias=True, device=device)
        self.wi = Linear(D, D, bias=True, device=device)
        self.wf = Linear(D, D, bias=True, device=device)
        self.wo_gate = Linear(D, D, bias=True, device=device)
        #: the diagonal recurrence of the z, i, f and o gates
        self.r = nn.Parameter(torch.empty((4, D), dtype=F32, device=device))
        self.ln2 = Norm(D, cfg.norm, cfg.norm_eps, device=device)
        self.ffn = MLP(D, int(D * 4 / 3), gated=True, act=cfg.act, device=device)
        for lin in (self.wz, self.wi, self.wf, self.wo_gate):  # the gates run in float32
            lin.reads_f32 = True

    def init(self, gen: torch.Generator) -> None:
        self.ln.init()
        self.ln2.init()
        for lin in (self.wz, self.wi, self.wf, self.wo_gate):
            lin.init(gen)
        truncated_normal_(self.r, 0.02, gen)
        self.ffn.init(gen)


def slstm_state(batch: int, cfg: ModelConfig, device=None, split: Optional[Split] = None) -> dict:
    """The initial state of an sLSTM block: every channel, or the rank's
    under ``split``."""
    sp = _slstm_split(split)
    D = cfg.d_model if sp is None else sp.channels.stop - sp.channels.start
    z = torch.zeros((batch, D), dtype=F32, device=device)
    return {"c": z, "n": z + 1e-6, "h": z.clone()}


def slstm_apply(p: SLSTM, x: torch.Tensor, cfg: ModelConfig, state: Optional[dict] = None,
                split: Optional[Split] = None):
    """The sequential recurrence over time (the paper: sLSTM does not
    parallelise), then the block's gated MLP. Under ``split``'s channels
    the gates, ``r`` and the state are the rank's channels, whose outputs
    are all-gathered into the residual; under its ``d_ff`` the MLP is the
    rank's block of its width."""
    sp = _slstm_split(split)
    state = state if state is not None else slstm_state(x.shape[0], cfg, x.device, sp)
    xn = p.ln(x) if sp is None else sp.enter(p.ln(x))
    # every step's input contributions, float32, gates stacked (B, S, 4, D)
    pre = torch.stack([lin(xn, dtype=F32) for lin in (p.wz, p.wi, p.wf, p.wo_gate)], dim=2)
    hs, c, n, h = slstm_recurrence(pre, p.r, state["c"], state["n"], state["h"])
    y = hs.to(x.dtype)
    x = x + (y if sp is None else sp.join(y))
    x = x + p.ffn(p.ln2(x), split)
    return x, {"c": c, "n": n, "h": h}


def slstm_recurrence(pre: torch.Tensor, r: torch.Tensor, c, n, h):
    """The sLSTM's steps over time: ``pre`` (B, S, 4, D) the input
    contributions, ``r`` the recurrent weights, (c, n, h) the state. Returns
    every step's h (B, S, D) and the last state. Elementwise only, no
    product: on meta tensors (``launch.dryrun``'s FLOP count, where the loop
    over 32,768 steps a layer took minutes a cell) it returns the shapes
    without running the loop."""
    if pre.device.type == "meta":
        return pre[:, :, 0].clone(), c, n, h
    hs = []
    for t in range(pre.shape[1]):
        g = pre[:, t] + r * h[:, None]  # (B, 4, D)
        z = torch.tanh(g[:, 0])
        ifo = torch.sigmoid(g[:, 1:])
        c = ifo[:, 1] * c + ifo[:, 0] * z
        n = ifo[:, 1] * n + ifo[:, 0]
        h = ifo[:, 2] * c / torch.clamp_min(n, 1e-6)
        hs.append(h)
    return torch.stack(hs, dim=1), c, n, h


# ---------------------------------------------------------------------------
# Model
# ---------------------------------------------------------------------------


class XlstmLM(DenseLM):
    """The ssm family's model: ``DenseLM``'s embedding, final norm, head,
    parameter drawing and serving copies, with xlstm's list of unlike
    blocks and its recurrent state in place of a KV cache."""

    FAMILY = "ssm"

    def _layer(self, idx: int, device) -> nn.Module:
        return (SLSTM if is_slstm(idx, self.cfg) else MLSTM)(self.cfg, device=device)

    def stacks(self) -> dict:
        return {}  # the layers stay a list, as the reference keeps them

    def init_state(self, batch: int, split: Optional[Split] = None) -> dict:
        """The zero state of every layer: whole, or the rank's heads and
        channels under ``split``."""
        make = lambda i: (slstm_state if is_slstm(i, self.cfg) else mlstm_state)(  # noqa: E731
            batch, self.cfg, self.device, split)
        return {"layers": [make(i) for i in range(self.cfg.num_layers)], "len": 0}

    def init_cache(self, batch: int, capacity: int) -> dict:
        """The state (a recurrent model keeps no positions: ``capacity`` is
        not read)."""
        return self.init_state(batch)

    def forward(self, tokens: torch.Tensor, state: Optional[dict] = None,
                split: Optional[Split] = None, *, gather: bool = True):
        """tokens ``(B, S)`` from ``state`` (the zero state where None) ->
        (the final hidden states ``(B, S, D)``, each layer's new state). A
        sharded model in training gathers each layer's parameters for its
        block (``gather``); serving (``gather=False``) reads the working
        copies that ``serving.steps.lay_out`` made. Under ``split`` the
        embedding is its vocabulary split's and each block computes the
        rank's heads or channels, reading its parameters as the split does
        (``Split.reads`` of the layer's kind)."""
        x = self._embed_inputs(tokens, None, split)
        states = []
        for idx, layer in enumerate(self.layers):
            st = state["layers"][idx] if state is not None else None
            reads = split.reads(layer=idx) if split is not None else None
            with self._gathered(layer, f"layers.{idx}.", reads) if gather else nullcontext():
                if is_slstm(idx, self.cfg):
                    x, st = slstm_apply(layer, x, self.cfg, st, split)
                else:
                    x, st = mlstm_apply(layer, x, self.cfg, st, split=split)
            states.append(st)
        return self.final_norm(x), states

    # -- training ----------------------------------------------------------

    def hidden_states(self, tokens: torch.Tensor,
                      split: Optional[Split] = None) -> torch.Tensor:
        """tokens ``(B, S)`` -> the final hidden states ``(B, S, D)`` from the
        zero state: the reference's ``forward``, whose layers take no remat.
        The sLSTM's loop over time is differentiated as it runs."""
        return self(tokens, None, split)[0]

    def loss(self, batch: dict, *, loss_chunk=None, batch_split: int = 1) -> torch.Tensor:
        """The reference's ``xlstm.loss_fn``: the mean next-token
        cross-entropy of ``batch`` (``tokens``, ``labels``) through the
        untied ``lm_head`` (vocabulary-parallel on a split mesh)."""
        self._check_released()
        split = self._train_split(batch["tokens"].shape[1])
        with self._head_gathered(split):
            return self._lm_loss(self.hidden_states(batch["tokens"], split), batch["labels"],
                                 loss_chunk, split)

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor):
        """The whole prompt ``(B, S)`` from the zero state; returns the state
        after it and the last position's logits ``(B, vocab_padded)``."""
        h, states = self(tokens, None, self.split, gather=False)
        return {"layers": states, "len": tokens.shape[1]}, self._logits(h[:, -1], self.split)

    def grow_cache(self, cache: dict, extra: int) -> dict:
        """The state as it is: a recurrent model needs no room to generate."""
        return cache

    @torch.no_grad()
    def decode_step(self, cache: dict, tokens: torch.Tensor):
        """One token per row, ``tokens`` ``(B, 1)``, from the state (mLSTM at
        chunk 1); returns the new state (new tensors) and the logits."""
        h, states = self(tokens, cache, self.split, gather=False)
        return {"layers": states, "len": cache["len"] + 1}, self._logits(h[:, -1], self.split)
