"""Encoder-decoder transformer (seamless-m4t family ``audio``).

The counterpart of ``src/repro/models/encdec.py``. Training:
``EncDecLM.loss(batch)`` (the reference's ``loss_fn``): ``encode`` over the
batch's ``frames``, then ``decode_states`` over its tokens, each stack's
layers checkpointed one by one under ``cfg.remat``. The audio frontend is a
stub, as in the reference: the batch carries precomputed frame embeddings
``frames`` ``(B, S_src, E)``, projected by ``src_proj``. The encoder is
bidirectional (non-causal self-attention with RoPE); the decoder is causal
self-attention, then cross-attention (no RoPE, non-causal, over the
encoder's output), then the MLP. Prefill runs the encoder and the decoder
prompt; all three attentions go through ``models.attention.attention`` with
the model's ``attn_impl`` (``pallas``: the Hopper flash-attention kernel,
non-causal with Sq = S and Skv = S_src for the cross attention).

The parameters are ``encoder.{i}.*`` and ``decoder.{i}.*`` per layer, which
the reference stacks on leading axes of ``enc_layers`` and ``dec_layers``
(``stacks()``), beside ``embed``, ``src_proj``, ``enc_norm``, ``final_norm``
and ``lm_head``. The cache is ``{"k", "v", "xk", "xv", "len"}``: the
decoder's self K/V ``(L_dec, B, S, KH, hd)`` and the static cross K/V
``(L_dec, B, S_src, KH, hd)``, bfloat16.

On a mesh whose ``model`` axis has more than one rank the model splits its
compute over it (``pshard.Split``, as ``DenseLM`` does): the three
attentions (encoder self, decoder self, cross) on the rank's heads, both
stacks' MLPs on its d_ff/|model| channels, the row products' partial
outputs summed over ``model``, and the embedding and head on the rank's
rows and columns of the vocabulary. Each stack's residual is
sequence-parallel over its own length where |model| divides it (the
decoder's by ``Split.seq``, the encoder's by ``Split.src``): ``src_proj``
and ``enc_norm`` run on the rank's positions of the source, and an
``S_src`` that |model| does not divide leaves the encoder's residual whole
while the decoder's is split. The encoder's output enters the decoder's
cross K/V (the rank's KV heads) through one gather over S_src a forward
(its backward one reduce-scatter sum), or through the "f" where the
encoder's residual is whole, not once a layer. The cross caches are then
the rank's KV heads, as the self caches are.

A quirk of the reference's launcher that the port keeps: it grows every
cache leaf of rank 4 or more by ``gen + 1`` positions (axis -3), the cross
caches ``xk`` and ``xv`` too, and decode cross-attends to every row of
``xk`` (``decode_attention_local(..., xk.shape[1])``), so each step also
attends to those zero keys with zero values. ``grow_cache`` and
``decode_step`` do the same, so that greedy tokens agree with the
reference's launcher.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn
from torch.nn import functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models.layers import COMPUTE, MLP, Embedding, Linear, Norm, rope_cos_sin
from repro_torch.models.pshard import Split
from repro_torch.models.stacking import apply_stack
from repro_torch.models.transformer import Attention, DenseLM

CACHE_KEYS = ("k", "v", "xk", "xv")


def _norm(cfg: ModelConfig, device) -> Norm:
    return Norm(cfg.d_model, cfg.norm, cfg.norm_eps, device=device)


class EncoderLayer(nn.Module):
    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.ln1 = _norm(cfg, device)
        self.attn = Attention(cfg, device=device)
        self.ln2 = _norm(cfg, device)
        # the reference's mlp_init default: gated, whatever mlp_gated says
        self.mlp = MLP(cfg.d_model, cfg.d_ff, gated=True, act=cfg.act, device=device)

    def init(self, gen: torch.Generator) -> None:
        self.ln1.init()
        self.ln2.init()
        self.attn.init(gen)
        self.mlp.init(gen)


class CrossDecoderLayer(nn.Module):
    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.ln1 = _norm(cfg, device)
        self.self_attn = Attention(cfg, device=device)
        self.lnx = _norm(cfg, device)
        self.cross_attn = Attention(cfg, device=device)
        self.ln2 = _norm(cfg, device)
        self.mlp = MLP(cfg.d_model, cfg.d_ff, gated=True, act=cfg.act, device=device)

    def init(self, gen: torch.Generator) -> None:
        for norm in (self.ln1, self.lnx, self.ln2):
            norm.init()
        self.self_attn.init(gen)
        self.cross_attn.init(gen)
        self.mlp.init(gen)


class EncDecLM(DenseLM):
    """The audio family's model. It keeps ``DenseLM``'s serving copies,
    device and logits, and builds its own parameters: no ``layers``, an
    encoder and a decoder stack instead."""

    FAMILY = "audio"

    def __init__(self, cfg: ModelConfig, *, device=None, generator=None):
        nn.Module.__init__(self)
        if cfg.family != self.FAMILY:
            raise ValueError(f"{type(self).__name__} serves the {self.FAMILY} family, "
                             f"not {cfg.family!r}")
        cfg.validate()
        self.cfg = cfg
        self.attn_impl = cfg.attn_impl
        e = cfg.encdec
        self.embed = Embedding(cfg.vocab_padded, cfg.d_model, device=device)
        self.src_proj = Linear(cfg.frontend.embed_dim, cfg.d_model, device=device)
        self.encoder = nn.ModuleList(EncoderLayer(cfg, device) for _ in range(e.enc_layers))
        self.enc_norm = _norm(cfg, device)
        self.decoder = nn.ModuleList(CrossDecoderLayer(cfg, device)
                                     for _ in range(e.dec_layers))
        self.final_norm = _norm(cfg, device)
        self.lm_head = Linear(cfg.d_model, cfg.vocab_padded, device=device)
        self.layout = None
        if generator is not None:
            self.init_weights(generator)
            self.prepare()

    def init_weights(self, generator: torch.Generator) -> "EncDecLM":
        self.embed.init(generator)
        self.src_proj.init(generator)
        for layer in (*self.encoder, *self.decoder):
            layer.init(generator)
        self.enc_norm.init()
        self.final_norm.init()
        self.lm_head.init(generator)
        return self

    def stacks(self) -> dict:
        return {"encoder": self.cfg.encdec.enc_layers, "decoder": self.cfg.encdec.dec_layers}

    #: the top-level parameters ``loss`` gathers once for the whole loss
    HEAD = ("embed", "src_proj", "enc_norm", "final_norm", "lm_head")

    def _stack(self, name: str, x: torch.Tensor, S: int, body,
               split: Optional[Split] = None, *, gather: bool = True) -> torch.Tensor:
        """``x`` (B, S, D; under ``split``'s ``seq`` the rank's positions of
        the ``S``) through the stack ``name`` (``encoder`` or ``decoder``) by
        ``body(layer, x, rope, split)``, as the reference's ``apply_stack(...,
        remat=cfg.remat)``: each layer one checkpoint (no ``remat_group``)
        while autograd records, its parameters gathered by the prefix
        ``name.{i}.`` on a sharded model in training (``gather``; under
        ``split``, as it reads them). Serving (``gather=False``) reads the
        working copies of ``serving.steps.lay_out``. The rotation covers all
        S positions: a block gathers its input over S first."""
        cfg = self.cfg
        layers = getattr(self, name)
        rope = rope_cos_sin(torch.arange(S, device=x.device), cfg.head_dim_, cfg.rope_theta)
        reads = split.reads() if split is not None else None
        gathered = (None if self.layout is None or not gather
                    else lambda i: self._gathered(layers[i], f"{name}.{i}.", reads))
        return apply_stack(layers, x, lambda layer, h: body(layer, h, rope, split),
                           remat_policy=cfg.remat if torch.is_grad_enabled() else "none",
                           gathered=gathered)

    def _encoder_layer(self, layer: EncoderLayer, h: torch.Tensor, rope: tuple,
                       split: Optional[Split] = None) -> torch.Tensor:
        """Non-causal self-attention with RoPE, then the MLP (on the rank's
        heads and channels under ``split``)."""
        q, k, v = layer.attn.qkv(self._attn_in(layer.ln1(h), split), rope)
        o = attn.attention(q, k, v, impl=self.attn_impl, causal=False, chunk=self.cfg.attn_chunk)
        h = h + self._attn_out(layer.attn, o, split)
        return h + layer.mlp(layer.ln2(h), split)

    def encode(self, frames: torch.Tensor, split: Optional[Split] = None, *,
               gather: bool = True) -> torch.Tensor:
        """frames ``(B, S_src, E)`` -> the encoder's output ``(B, S_src, D)``:
        the reference's ``encode``, for training and for serving (under
        ``no_grad``, ``gather=False``: :meth:`_stack`). ``split``: the
        encoder's (``Split.src``); under its ``seq``, ``src_proj``, the
        layers' residual and ``enc_norm`` run on the rank's positions of the
        source, and so is the output."""
        x = frames if split is None else split.own(frames)
        h = self._stack("encoder", self.src_proj(x), frames.shape[1], self._encoder_layer, split,
                        gather=gather)
        return self.enc_norm(h)

    @staticmethod
    def _cross_in(enc_out: torch.Tensor, split: Optional[Split]) -> torch.Tensor:
        """The encoder's output into the decoder's cross K/V, once a
        forward: under ``split`` (the decoder's) gathered over S_src from the
        rank's positions, or through the "f" where the encoder's residual is
        whole, for the rank's KV heads; gathered for cross attentions
        computed whole."""
        if split is None:
            return enc_out
        src = split.src
        return src.enter(enc_out) if split.heads is not None else src.gather(enc_out)

    def _decoder_layer(self, layer: CrossDecoderLayer, x: torch.Tensor, rope: tuple,
                       split: Optional[Split], kv_in: torch.Tensor) -> tuple:
        """One decoder layer over the residual ``x``: causal self-attention,
        cross attention over ``kv_in`` (the encoder's output, :meth:`_cross_in`),
        the MLP. Returns (x', self K, self V, cross K, cross V)."""
        q, k, v = layer.self_attn.qkv(self._attn_in(layer.ln1(x), split), rope)
        o = attn.attention(q, k, v, impl=self.attn_impl, causal=True, chunk=self.cfg.attn_chunk)
        x = x + self._attn_out(layer.self_attn, o, split)
        ck, cv = self._cross_kv(layer, kv_in)
        x = x + self._cross_attend(layer, self._attn_in(layer.lnx(x), split), ck, cv, split)
        return x + layer.mlp(layer.ln2(x), split), k, v, ck, cv

    # -- training ------------------------------------------------------------

    def decode_states(self, tokens: torch.Tensor, enc_out: torch.Tensor,
                      split: Optional[Split] = None) -> torch.Tensor:
        """The reference's ``decode_states``: tokens ``(B, S)`` through the
        decoder (causal self-attention, cross attention over ``enc_out``
        with no RoPE on its keys, the MLP) -> final hidden states
        ``(B, S, D)`` (under ``split``'s ``seq``, the rank's positions)."""
        kv_in = self._cross_in(enc_out, split)

        def body(layer, x, rope, sp):
            return self._decoder_layer(layer, x, rope, sp, kv_in)[0]

        x = self._embed_inputs(tokens, None, split)
        return self.final_norm(self._stack("decoder", x, tokens.shape[1], body, split))

    def hidden_states(self, tokens: torch.Tensor, frames: torch.Tensor,
                      split: Optional[Split] = None) -> torch.Tensor:
        """The decoder's final hidden states ``(B, S, D)`` of ``tokens`` over
        the encoder's output of ``frames``."""
        enc = split.src if split is not None else None
        return self.decode_states(tokens, self.encode(frames, enc), split)

    def _train_split(self, S: int, S_src: int = 1) -> Optional[Split]:
        split = super()._train_split(S)
        return None if split is None else split.at(S, S_src)

    def loss(self, batch: dict, *, loss_chunk=None, batch_split: int = 1) -> torch.Tensor:
        """The reference's ``encdec.loss_fn``: the mean next-token
        cross-entropy of ``batch`` (``tokens``, ``labels``, ``frames``)."""
        self._check_released()
        split = self._train_split(batch["tokens"].shape[1], batch["frames"].shape[1])
        with self._head_gathered(split):
            h = self.hidden_states(batch["tokens"], batch["frames"], split)
            return self._lm_loss(h, batch["labels"], loss_chunk, split)

    # -- serving -------------------------------------------------------------

    def _cross_kv(self, layer: CrossDecoderLayer, enc_out: torch.Tensor):
        """The cross K/V of the encoder's output (every KV head, or the
        rank's under a split: ``wk``/``wv`` are its blocks)."""
        B, Ss, _ = enc_out.shape
        k = layer.cross_attn.wk(enc_out).reshape(B, Ss, -1, self.cfg.head_dim_)
        v = layer.cross_attn.wv(enc_out).reshape(B, Ss, -1, self.cfg.head_dim_)
        return k, v  # no RoPE on cross attention

    def _cross_attend(self, layer: CrossDecoderLayer, h: torch.Tensor, k, v,
                      split: Optional[Split] = None) -> torch.Tensor:
        """Non-causal attention of the normed decoder states ``h`` ``(B, S, D)``
        over the encoder's K/V, through the output projection (on the rank's
        heads under ``split``, ``wo``'s partials summed)."""
        cfg = self.cfg
        B, S, _ = h.shape
        q = layer.cross_attn.wq(h).reshape(B, S, -1, cfg.head_dim_)
        o = attn.attention(q, k, v, impl=self.attn_impl, causal=False, chunk=cfg.attn_chunk)
        return self._attn_out(layer.cross_attn, o, split)

    def init_cache(self, batch: int, capacity: int) -> dict:
        cfg = self.cfg
        shape = lambda s: (cfg.encdec.dec_layers, batch, s, cfg.num_kv_heads,  # noqa: E731
                           cfg.head_dim_)
        zeros = lambda s: torch.zeros(shape(s), dtype=COMPUTE, device=self.device)  # noqa: E731
        src = max(1, capacity // cfg.encdec.src_ratio)  # the frames of a prompt
        return {"k": zeros(capacity), "v": zeros(capacity), "xk": zeros(src),
                "xv": zeros(src), "len": 0}

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor, frames: torch.Tensor):
        """The encoder over ``frames`` ``(B, S_src, E)``, then the decoder
        over the prompt ``tokens`` ``(B, S)``; returns the cache and the last
        position's logits ``(B, vocab_padded)``. Under the model's ``split``
        the cache holds the rank's KV heads (self and cross) where it splits
        the heads."""
        S = tokens.shape[1]
        split = self.split.at(S, frames.shape[1]) if self.split is not None else None
        enc_out = self.encode(frames, split.src if split is not None else None, gather=False)
        kv_in = self._cross_in(enc_out, split)
        x = self._embed_inputs(tokens, None, split)
        rope = rope_cos_sin(torch.arange(S, device=x.device), self.cfg.head_dim_,
                            self.cfg.rope_theta)
        cache = {n: [] for n in CACHE_KEYS}
        for layer in self.decoder:
            x, *kv = self._decoder_layer(layer, x, rope, split, kv_in)
            for name, t in zip(CACHE_KEYS, kv):
                cache[name].append(t.to(COMPUTE))
        cache = {n: torch.stack(ts) for n, ts in cache.items()}
        cache["len"] = S
        return cache, self._last_logits(x, split)

    def grow_cache(self, cache: dict, extra: int) -> dict:
        """Every K/V leaf, the cross caches too, with ``extra`` more (zero)
        positions: the reference launcher's growth (the module's note)."""
        pad = (0, 0, 0, 0, 0, extra)
        return {**{n: F.pad(cache[n], pad) for n in CACHE_KEYS}, "len": cache["len"]}

    @torch.no_grad()
    def decode_step(self, cache: dict, tokens: torch.Tensor, attn_fn=None):
        """One token per row, ``tokens`` ``(B, 1)``: self-attention over the
        ``len + 1`` cached positions (its K and V written at ``len``, in
        place) through the slot ``attn_fn`` (the model's ``decode_attn_fn``
        where None), cross-attention over every row of ``xk`` and ``xv``,
        local (``src/repro/models/encdec.py:187-195``). Under the model's
        ``split`` every attention runs on the rank's heads where it splits
        them (its slices of the self and cross caches)."""
        cfg = self.cfg
        split = self.split
        slot = attn.decode_slot(attn_fn if attn_fn is not None else self.decode_attn_fn)
        B = tokens.shape[0]
        pos = int(cache["len"])
        cap = slot.capacity(cache["k"][0])
        if pos >= cap:
            raise ValueError(f"the cache holds {cap} positions, all used; "
                             "grow it before decoding")
        x = self._embed_inputs(tokens, None, split)
        rope = rope_cos_sin(torch.arange(pos, pos + 1, device=x.device), cfg.head_dim_,
                            cfg.rope_theta)
        n_src = cache["xk"].shape[2]
        for i, layer in enumerate(self.decoder):
            q, k, v = layer.self_attn.qkv(layer.ln1(x), rope)
            slot.write(cache["k"][i], k, pos)
            slot.write(cache["v"][i], v, pos)
            o = slot(q, cache["k"][i], cache["v"][i], pos + 1, None)
            x = x + self._attn_out(layer.self_attn, o, split)
            qx = layer.cross_attn.wq(layer.lnx(x)).reshape(B, 1, -1, cfg.head_dim_)
            ox = attn.decode_attention_local(qx, cache["xk"][i], cache["xv"][i], n_src)
            x = x + self._attn_out(layer.cross_attn, ox, split)
            x = x + layer.mlp(layer.ln2(x), split)
        return {**{n: cache[n] for n in CACHE_KEYS}, "len": pos + 1}, \
            self._last_logits(x, split)
