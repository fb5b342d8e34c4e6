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

A quirk of the reference's launcher that the port keeps: it grows every
cache leaf of rank 4 or more by ``gen + 1`` positions (axis -3), the cross
caches ``xk`` and ``xv`` too, and decode cross-attends to every row of
``xk`` (``decode_attention_local(..., xk.shape[1])``), so each step also
attends to those zero keys with zero values. ``grow_cache`` and
``decode_step`` do the same, so that greedy tokens agree with the
reference's launcher.
"""
from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models.layers import COMPUTE, MLP, Embedding, Linear, Norm, rope_cos_sin
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

    def _stack(self, name: str, x: torch.Tensor, body) -> torch.Tensor:
        """``x`` (B, S, D) through the stack ``name`` (``encoder`` or
        ``decoder``) by ``body(layer, x, rope)``, as the reference's
        ``apply_stack(..., remat=cfg.remat)``: each layer one checkpoint
        (no ``remat_group``) while autograd records, its parameters gathered
        by the prefix ``name.{i}.`` on a sharded model."""
        cfg = self.cfg
        layers = getattr(self, name)
        rope = rope_cos_sin(torch.arange(x.shape[1], device=x.device), cfg.head_dim_,
                            cfg.rope_theta)
        gathered = (None if self.layout is None
                    else lambda i: self._gathered(layers[i], f"{name}.{i}."))
        return apply_stack(layers, x, lambda layer, h: body(layer, h, rope),
                           remat_policy=cfg.remat if torch.is_grad_enabled() else "none",
                           gathered=gathered)

    def _encoder_layer(self, layer: EncoderLayer, h: torch.Tensor, rope: tuple) -> torch.Tensor:
        """Non-causal self-attention with RoPE, then the MLP."""
        B, Ss, _ = h.shape
        q, k, v = layer.attn.qkv(layer.ln1(h), rope)
        o = attn.attention(q, k, v, impl=self.attn_impl, causal=False, chunk=self.cfg.attn_chunk)
        h = h + layer.attn.wo(o.reshape(B, Ss, -1))
        return h + layer.mlp(layer.ln2(h))

    def encode(self, frames: torch.Tensor) -> torch.Tensor:
        """frames ``(B, S_src, E)`` -> the encoder's output ``(B, S_src, D)``:
        the reference's ``encode``, for serving (under ``no_grad``) and
        training."""
        h = self._stack("encoder", self.src_proj(frames), self._encoder_layer)
        return self.enc_norm(h)

    # -- training ------------------------------------------------------------

    def decode_states(self, tokens: torch.Tensor, enc_out: torch.Tensor) -> torch.Tensor:
        """The reference's ``decode_states``: tokens ``(B, S)`` through the
        decoder (causal self-attention, cross attention over ``enc_out``
        with no RoPE on its keys, the MLP) -> final hidden states
        ``(B, S, D)``."""
        def body(layer: CrossDecoderLayer, x: torch.Tensor, rope: tuple) -> torch.Tensor:
            B, S, _ = x.shape
            q, k, v = layer.self_attn.qkv(layer.ln1(x), rope)
            o = attn.attention(q, k, v, impl=self.attn_impl, causal=True,
                               chunk=self.cfg.attn_chunk)
            x = x + layer.self_attn.wo(o.reshape(B, S, -1))
            ck, cv = self._cross_kv(layer, enc_out)
            x = x + self._cross_attend(layer, layer.lnx(x), ck, cv)
            return x + layer.mlp(layer.ln2(x))

        return self.final_norm(self._stack("decoder", self.embed(tokens), body))

    def hidden_states(self, tokens: torch.Tensor, frames: torch.Tensor) -> torch.Tensor:
        """The decoder's final hidden states ``(B, S, D)`` of ``tokens`` over
        the encoder's output of ``frames``."""
        return self.decode_states(tokens, self.encode(frames))

    def loss(self, batch: dict, *, loss_chunk=None, batch_split: int = 1) -> torch.Tensor:
        """The reference's ``encdec.loss_fn``: the mean next-token
        cross-entropy of ``batch`` (``tokens``, ``labels``, ``frames``)."""
        self._check_released()
        with self._head_gathered():
            h = self.hidden_states(batch["tokens"], batch["frames"])
            return self._lm_loss(h, batch["labels"], loss_chunk)

    # -- serving -------------------------------------------------------------

    def _cross_kv(self, layer: CrossDecoderLayer, enc_out: torch.Tensor):
        cfg = self.cfg
        B, Ss, _ = enc_out.shape
        k = layer.cross_attn.wk(enc_out).reshape(B, Ss, cfg.num_kv_heads, cfg.head_dim_)
        v = layer.cross_attn.wv(enc_out).reshape(B, Ss, cfg.num_kv_heads, cfg.head_dim_)
        return k, v  # no RoPE on cross attention

    def _cross_attend(self, layer: CrossDecoderLayer, h: torch.Tensor, k, v) -> torch.Tensor:
        """Non-causal attention of the normed decoder states ``h`` ``(B, S, D)``
        over the encoder's K/V, through the output projection."""
        cfg = self.cfg
        B, S, _ = h.shape
        q = layer.cross_attn.wq(h).reshape(B, S, cfg.num_heads, cfg.head_dim_)
        o = attn.attention(q, k, v, impl=self.attn_impl, causal=False, chunk=cfg.attn_chunk)
        return layer.cross_attn.wo(o.reshape(B, S, -1))

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
        position's logits ``(B, vocab_padded)``."""
        cfg = self.cfg
        enc_out = self.encode(frames)
        B, S = tokens.shape
        x = self.embed(tokens)
        rope = rope_cos_sin(torch.arange(S, device=x.device), cfg.head_dim_, cfg.rope_theta)
        cache = {n: [] for n in CACHE_KEYS}
        for layer in self.decoder:
            q, k, v = layer.self_attn.qkv(layer.ln1(x), rope)
            o = attn.attention(q, k, v, impl=self.attn_impl, causal=True, chunk=cfg.attn_chunk)
            x = x + layer.self_attn.wo(o.reshape(B, S, -1))
            ck, cv = self._cross_kv(layer, enc_out)
            x = x + self._cross_attend(layer, layer.lnx(x), ck, cv)
            x = x + layer.mlp(layer.ln2(x))
            for name, t in zip(CACHE_KEYS, (k, v, ck, cv)):
                cache[name].append(t.to(COMPUTE))
        cache = {n: torch.stack(ts) for n, ts in cache.items()}
        cache["len"] = S
        return cache, self._logits(self.final_norm(x)[:, -1])

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
        local (``src/repro/models/encdec.py:187-195``)."""
        cfg = self.cfg
        slot = attn.decode_slot(attn_fn if attn_fn is not None else self.decode_attn_fn)
        B = tokens.shape[0]
        pos = int(cache["len"])
        cap = slot.capacity(cache["k"][0])
        if pos >= cap:
            raise ValueError(f"the cache holds {cap} positions, all used; "
                             "grow it before decoding")
        x = self.embed(tokens)
        rope = rope_cos_sin(torch.arange(pos, pos + 1, device=x.device), cfg.head_dim_,
                            cfg.rope_theta)
        n_src = cache["xk"].shape[2]
        for i, layer in enumerate(self.decoder):
            q, k, v = layer.self_attn.qkv(layer.ln1(x), rope)
            slot.write(cache["k"][i], k, pos)
            slot.write(cache["v"][i], v, pos)
            o = slot(q, cache["k"][i], cache["v"][i], pos + 1, None)
            x = x + layer.self_attn.wo(o.reshape(B, 1, -1))
            qx = layer.cross_attn.wq(layer.lnx(x)).reshape(B, 1, cfg.num_heads, cfg.head_dim_)
            ox = attn.decode_attention_local(qx, cache["xk"][i], cache["xv"][i], n_src)
            x = x + layer.cross_attn.wo(ox.reshape(B, 1, -1))
            x = x + layer.mlp(layer.ln2(x))
        return {**{n: cache[n] for n in CACHE_KEYS}, "len": pos + 1}, \
            self._logits(self.final_norm(x)[:, -1])
