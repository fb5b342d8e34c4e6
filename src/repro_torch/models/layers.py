"""Core layers of the dense family, in PyTorch.

The counterpart of ``src/repro/models/layers.py``, with its cast points:
parameters are float32; ``Linear`` multiplies in bfloat16 (both operands cast,
bias added in bfloat16); norms work in float32 and cast to bfloat16 at the
end; the embedding casts the table before the gather; RoPE works in float32
on split halves and casts back.

Weights keep the reference's ``(d_in, d_out)`` layout, so parameters carry
across from the reference unchanged. For serving, the bfloat16 copies the
forward pass multiplies with are made once by :meth:`prepare` (numerically
the reference's cast at every call, without re-casting every weight per
decoded token); call it again after changing a weight. For training,
:meth:`release` drops them: the forward pass then casts the float32 weight at
every call, inside the autograd graph, as the reference does, so that the
gradient reaches the float32 weight.

The losses (``softmax_cross_entropy``, ``chunked_lm_loss``) are the
reference's, the chunked one recomputing each chunk's logits in backward;
``vocab_parallel_lm_loss`` is the chunked one on the rank's columns of the
vocabulary (``models.pshard``'s vocabulary split).
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn
from torch.nn import functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.obs.ranges import spanned

COMPUTE = torch.bfloat16


def truncated_normal_(t: torch.Tensor, scale: float, gen: torch.Generator) -> torch.Tensor:
    """In place: ``scale`` times a standard normal truncated to [-2, 2], the
    distribution of ``layers.truncated_normal_init`` (not its draws)."""
    with torch.no_grad():
        nn.init.trunc_normal_(t, mean=0.0, std=1.0, a=-2.0, b=2.0, generator=gen)
        return t.mul_(scale)


def _param(shape, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=torch.float32, device=device))


class Linear(nn.Module):
    """``y = x @ w (+ b)`` in bfloat16; ``w`` is ``(d_in, d_out)`` float32."""

    #: True where the serving forward also multiplies the float32 weight
    #: (``forward(..., dtype=torch.float32)``, the MoE router): a sharded
    #: server then keeps a float32 working copy beside the bfloat16 one
    reads_f32 = False

    def __init__(self, d_in: int, d_out: int, *, bias: bool = False, device=None):
        super().__init__()
        self.w = _param((d_in, d_out), device)
        self.b = _param((d_out,), device) if bias else None
        self.register_buffer("w16", None, persistent=False)
        self.register_buffer("b16", None, persistent=False)

    def init(self, gen: torch.Generator, scale: Optional[float] = None) -> None:
        truncated_normal_(self.w, scale if scale is not None else self.w.shape[0] ** -0.5, gen)
        if self.b is not None:
            nn.init.zeros_(self.b)

    def prepare(self) -> None:
        self.w16 = self.w.detach().to(COMPUTE)
        self.b16 = None if self.b is None else self.b.detach().to(COMPUTE)

    def release(self) -> None:
        self.w16 = self.b16 = None

    def forward(self, x: torch.Tensor, dtype: torch.dtype = COMPUTE) -> torch.Tensor:
        """``dtype=torch.float32`` multiplies the float32 weight in float32
        (the reference's ``linear(..., dtype=jnp.float32)``, xlstm's gates);
        TF32 stays off, PyTorch's default."""
        if dtype == torch.float32:
            y = _product(x.float(), self.w)
            return y if self.b is None else y + self.b
        if self.w16 is None:  # training: cast inside the graph
            y = _product(x.to(COMPUTE), _cast(self.w))
            return y if self.b is None else y + _cast(self.b)
        y = _product(x.to(COMPUTE), self.w16)
        return y if self.b16 is None else y + self.b16

    def partial(self, x: torch.Tensor) -> torch.Tensor:
        """A row product's partial output under a compute split over
        ``model`` (``pshard.Split.reduce`` sums it): the products of the
        bfloat16 operands accumulated in float32 and not rounded, so that
        the sum over ``model`` rounds once, where one rank's product does.
        The bias, if any, is the caller's to add once."""
        w = self.w16 if self.w16 is not None else self.w.to(COMPUTE)
        return x.to(COMPUTE).float() @ w.float()


@spanned("model.linear.cast")
def _cast(w: torch.Tensor) -> torch.Tensor:
    """A float32 weight's bfloat16 copy inside the training graph."""
    return w.to(COMPUTE)


@spanned("model.linear.matmul")
def _product(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return x @ w


class Norm(nn.Module):
    """RMSNorm (``scale``) or LayerNorm (``scale`` and ``bias``), computed in
    float32 and cast to bfloat16."""

    def __init__(self, d: int, kind: str = "rmsnorm", eps: float = 1e-6, device=None):
        super().__init__()
        if kind not in ("rmsnorm", "layernorm"):
            raise ValueError(f"unknown norm {kind!r}")
        self.eps = eps
        self.scale = _param((d,), device)
        self.bias = _param((d,), device) if kind == "layernorm" else None

    def init(self) -> None:
        nn.init.ones_(self.scale)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return apply_norm(x, self.scale, self.bias, eps=self.eps)


@spanned("model.norm")
def apply_norm(x: torch.Tensor, scale: torch.Tensor, bias: Optional[torch.Tensor] = None, *,
               eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    if bias is not None:  # layernorm
        mu = xf.mean(dim=-1, keepdim=True)
        var = (xf - mu).square().mean(dim=-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + eps) * scale + bias
    else:  # rmsnorm
        ms = xf.square().mean(dim=-1, keepdim=True)
        y = xf * torch.rsqrt(ms + eps) * scale
    return y.to(COMPUTE)


class Embedding(nn.Module):
    """``table`` ``(vocab, d)`` float32, gathered from its bfloat16 copy."""

    def __init__(self, vocab: int, d: int, device=None):
        super().__init__()
        self.table = _param((vocab, d), device)
        self.register_buffer("table16", None, persistent=False)

    def init(self, gen: torch.Generator) -> None:
        truncated_normal_(self.table, 0.02, gen)

    def prepare(self) -> None:
        self.table16 = self.table.detach().to(COMPUTE)

    def release(self) -> None:
        self.table16 = None

    def forward(self, tokens: torch.Tensor, rows: Optional[slice] = None) -> torch.Tensor:
        """The rows of ``tokens``. ``rows``: the vocabulary's rows that the
        table holds (the vocabulary split's block): a token outside them
        looks up zeros, for the split's sum over ``model``."""
        table = self.table.to(COMPUTE) if self.table16 is None else self.table16
        if rows is None:
            return table[tokens]
        local = tokens - rows.start
        hit = (local >= 0) & (local < table.shape[0])
        out = table[local.clamp(0, table.shape[0] - 1)]
        return out.masked_fill(~hit[..., None], 0)


def activation(x: torch.Tensor, act: str) -> torch.Tensor:
    """silu, or the tanh approximation of gelu that ``jax.nn.gelu`` defaults
    to (``torch``'s default is the exact erf form)."""
    return F.silu(x) if act == "silu" else F.gelu(x, approximate="tanh")


@spanned("model.mlp_act")
def glu(gate: Optional[torch.Tensor], u: torch.Tensor, act: str) -> torch.Tensor:
    """The MLP's activation: ``activation(gate) * u``, or ``activation(u)``
    for the two-matrix MLP (``gate`` None)."""
    return activation(gate, act) * u if gate is not None else activation(u, act)


class MLP(nn.Module):
    """SwiGLU / GeGLU (gated, three matrices) or the classic two-matrix MLP."""

    def __init__(self, d: int, f: int, *, gated: bool = True, act: str = "silu", device=None):
        super().__init__()
        self.act = act
        self.up = Linear(d, f, device=device)
        self.down = Linear(f, d, device=device)
        self.gate = Linear(d, f, device=device) if gated else None

    def init(self, gen: torch.Generator) -> None:
        if self.gate is not None:
            self.gate.init(gen)
        self.up.init(gen)
        self.down.init(gen, scale=self.down.w.shape[0] ** -0.5)

    def forward(self, x: torch.Tensor, split=None) -> torch.Tensor:
        """``split`` (a ``pshard.Split`` whose ``d_ff`` is set): ``gate`` and
        ``up`` are the rank's column blocks and ``down`` its row block, so the
        GLU runs on d_ff/|model| channels; ``x`` enters through the split's
        "f" and the partial outputs (``Linear.partial``) are summed by its
        "g"."""
        if split is not None and split.d_ff is None:
            split = None
        if split is not None:
            x = split.enter(x)
        u = self.up(x)
        h = glu(self.gate(x) if self.gate is not None else None, u, self.act)
        return self.down(h) if split is None else split.reduce(self.down.partial(h))


def rope_frequencies(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return theta ** (-torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim)


def rope_cos_sin(positions: torch.Tensor, head_dim: int, theta: float):
    """cos and sin of the rotation angles, (..., S, 1, hd/2) float32: once per
    forward pass, shared by every layer's q and k."""
    freqs = rope_frequencies(head_dim, theta, device=positions.device)
    angles = positions[..., None].float() * freqs  # (..., S, hd/2)
    return torch.cos(angles)[..., None, :], torch.sin(angles)[..., None, :]


@spanned("model.rope")
def rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """The split-halves rotation (``x1, x2 = split(x, 2)``, not interleaved
    pairs) in float32, cast back to x's dtype."""
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, H, hd); positions broadcastable to (..., S)."""
    return rotate(x, *rope_cos_sin(positions, x.shape[-1], theta))


def mask_padded_vocab(logits: torch.Tensor, real_vocab: int) -> torch.Tensor:
    """-1e30 at the padded vocab columns (``vocab_padded > vocab_size``)."""
    V = logits.shape[-1]
    if V == real_vocab:
        return logits
    idx = torch.arange(V, device=logits.device)
    return logits.masked_fill(idx >= real_vocab, -1e30)


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                          real_vocab: Optional[int] = None) -> torch.Tensor:
    """logits: (..., V); labels: (...) integers. Returns the mean loss (fp32)."""
    logits = logits.float()
    if real_vocab is not None:
        logits = mask_padded_vocab(logits, real_vocab)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return (logz - gold).mean()


def _chunk_loss_sum(hc: torch.Tensor, head16: torch.Tensor, lc: torch.Tensor,
                    real_vocab: Optional[int]) -> torch.Tensor:
    logits = (hc.to(COMPUTE) @ head16).float()
    if real_vocab is not None:
        logits = mask_padded_vocab(logits, real_vocab)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, lc.long()[..., None])[..., 0]
    return (logz - gold).sum()


def chunked_lm_loss(h: torch.Tensor, head_w: torch.Tensor, labels: torch.Tensor, *,
                    chunk: Optional[int] = None,
                    real_vocab: Optional[int] = None) -> torch.Tensor:
    """Cross-entropy over a (possibly huge) vocab without holding all logits.

    h: (B, S, D) final hidden states; head_w: (D, V) float32; labels: (B, S).
    When ``chunk`` divides S, loops over sequence chunks, each under
    ``torch.utils.checkpoint``, so the live logits are (B, chunk, V) in both
    passes: backward recomputes a chunk's logits instead of keeping them
    (the reference's ``jax.checkpoint`` on its scan body). ``chunk=None``
    computes unchunked.
    """
    B, S, _ = h.shape
    head16 = _cast(head_w)
    if chunk is None or chunk >= S:
        return softmax_cross_entropy(h.to(COMPUTE) @ head16, labels, real_vocab)
    if S % chunk:
        raise ValueError(f"loss chunk {chunk} does not divide the sequence {S}")
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for c in range(0, S, chunk):
        total = total + checkpoint(_chunk_loss_sum, h[:, c:c + chunk], head16,
                                   labels[:, c:c + chunk], real_vocab, use_reentrant=False)
    return total / (B * S)


class _HeadColumns(torch.autograd.Function):
    """``h @ w16`` of bfloat16 operands (``h`` float32 of bfloat16 values),
    rounded to bfloat16 as the whole head's product is, for the rank's
    columns of a head split over the vocabulary: the backward gives ``h``'s
    cotangent in float32, unrounded (the rank's part of a sum over the
    vocabulary, which the caller's "f" sums and rounds once, as the whole
    product rounds once), and ``w16``'s in bfloat16 as the whole head's."""

    @staticmethod
    def forward(ctx, h, w16):
        h16 = h.to(COMPUTE)
        ctx.save_for_backward(h16, w16)
        return h16 @ w16

    @staticmethod
    def backward(ctx, g):
        h16, w16 = ctx.saved_tensors
        dw = h16.reshape(-1, h16.shape[-1]).T @ g.reshape(-1, g.shape[-1])
        return g.float() @ w16.float().T, dw


def _vocab_chunk_loss_sum(hc: torch.Tensor, head16: torch.Tensor, lc: torch.Tensor,
                          first: int, real_vocab: Optional[int], mesh, axis: str) -> torch.Tensor:
    """``_chunk_loss_sum`` on the rank's columns ``[first, first + V/n)``:
    the row max, the gold logit and the sum of exponentials summed over
    ``axis``. The sums' backward passes the cotangent on: every rank
    computes the same loss from them."""
    from repro_torch.comm import collectives

    logits = _HeadColumns.apply(hc, head16).float()
    V = logits.shape[-1]
    if real_vocab is not None and first + V > real_vocab:  # the padded columns
        cols = torch.arange(first, first + V, device=logits.device)
        logits = logits.masked_fill(cols >= real_vocab, -1e30)
    top = collectives.all_reduce_max(logits.detach().amax(dim=-1), mesh, axis, op="loss_max")
    local = lc.long() - first
    hit = (local >= 0) & (local < V)
    gold = torch.gather(logits, -1, local.clamp(0, V - 1)[..., None])[..., 0]
    gold = collectives.all_reduce_grad(gold.masked_fill(~hit, 0), mesh, axis,
                                       downstream="replicated", op="loss_gold")
    sumexp = (logits - top[..., None]).exp().sum(dim=-1)
    sumexp = collectives.all_reduce_grad(sumexp, mesh, axis, downstream="replicated",
                                         op="loss_sumexp")
    return (top + sumexp.log() - gold).sum()


def vocab_parallel_lm_loss(h: torch.Tensor, head_w: torch.Tensor, labels: torch.Tensor,
                           vocab: slice, mesh, axis: str = "model", *,
                           chunk: Optional[int] = None,
                           real_vocab: Optional[int] = None) -> torch.Tensor:
    """:func:`chunked_lm_loss` with the vocabulary split over ``axis``: ``h``
    (B, S, D) whole on every rank of it, ``head_w`` (D, V/n) float32 the
    rank's columns ``vocab`` of the head. Each chunk (under
    ``torch.utils.checkpoint`` as there) takes three all-reduces over
    ``axis``: the row max (``loss_max``), the gold logit from the rank that
    holds the label (``loss_gold``) and the sum of exponentials
    (``loss_sumexp``); the padded columns are masked by their global index.
    A recomputed chunk issues them again in backward, in the same order on
    every rank. The mean is over all B·S tokens; the cotangent of ``h`` is
    this rank's columns' part of the sum over ``axis``."""
    B, S, _ = h.shape
    head16 = _cast(head_w)
    if chunk is None or chunk >= S:
        return _vocab_chunk_loss_sum(h, head16, labels, vocab.start, real_vocab, mesh,
                                     axis) / (B * S)
    if S % chunk:
        raise ValueError(f"loss chunk {chunk} does not divide the sequence {S}")
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for c in range(0, S, chunk):
        total = total + checkpoint(_vocab_chunk_loss_sum, h[:, c:c + chunk], head16,
                                   labels[:, c:c + chunk], vocab.start, real_vocab, mesh, axis,
                                   use_reentrant=False)
    return total / (B * S)
