"""Dense GQA transformer LM (llama / qwen / mistral / granite), and the vlm
family (phi-3-vision) that serves through it.

The counterpart of ``src/repro/models/transformer.py``. Training:
``DenseLM.hidden_states(tokens)`` and ``DenseLM.loss(batch)`` (the
reference's ``loss_fn``), on a model whose serving copies are released
(:meth:`DenseLM.release`) so that every weight is cast inside the autograd
graph; each layer is recomputed in backward under ``cfg.remat = "full"``.
A model sharded over a mesh (:meth:`DenseLM.shard`) holds only its rank's
block of each parameter and gathers the full tensors for the training
forward (``sharding.Layout``); its code paths are the full-shape ones.
Serving: ``DenseLM.prefill(tokens, patches=None) -> (cache, logits_last)``
and ``DenseLM.decode_step(cache, tokens) -> (cache, logits)``, with the
reference's KV cache ``{"k", "v"}: (L, B, S, KH, hd)`` bfloat16 plus ``"len"``
(here a Python int). The loop over ``layers`` threads each layer's cache as
``stacking.apply_stack_with_cache`` does on one device. ``VlmLM`` is the
vlm family's row of the reference's table: the dense model, whose prefill
takes the frontend's ``patches`` ``(B, P, D)`` over the first P token
embeddings (the reference's ``_VLM`` shares ``transformer.prefill``, which
reads ``batch["patches"]``).

Parameter names follow the reference's tree (``embed.table``,
``layers.{i}.attn.wq.w``, ``final_norm.scale``, ...) so that
``convert.params_from_reference`` maps leaf to parameter by name.

``attn_impl`` starts as the config's and can be switched on a built model;
it is the Select of ``models.attention.attention`` (``"pallas"`` is the
Hopper flash-attention kernel). Decode attends through the KV-partition
chunnel slot, ``decode_step(..., attn_fn)`` or the model's
``decode_attn_fn`` (``registry.build(decode_attn_fn=...)``):
``decode_attention_local`` over a whole local cache by default, as the
reference's, or a branch of ``comm.kvshard`` over this rank's shard of it.
``mesh`` is the rank's mesh when the model serves on one
(``serving.steps``; the moe family's expert dispatch reads it).
"""
from __future__ import annotations

from contextlib import ExitStack, nullcontext
from typing import Optional

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models.layers import (
    COMPUTE,
    MLP,
    Embedding,
    Linear,
    Norm,
    chunked_lm_loss,
    mask_padded_vocab,
    rope_cos_sin,
    rotate,
)
from repro_torch.models.sharding import Layout
from repro_torch.models.stacking import apply_stack


class Attention(nn.Module):
    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        hd = cfg.head_dim_
        self.cfg = cfg
        self.wq = Linear(cfg.d_model, cfg.num_heads * hd, bias=cfg.qkv_bias, device=device)
        self.wk = Linear(cfg.d_model, cfg.num_kv_heads * hd, bias=cfg.qkv_bias, device=device)
        self.wv = Linear(cfg.d_model, cfg.num_kv_heads * hd, bias=cfg.qkv_bias, device=device)
        self.wo = Linear(cfg.num_heads * hd, cfg.d_model, device=device)

    def init(self, gen: torch.Generator) -> None:
        for lin in (self.wq, self.wk, self.wv, self.wo):
            lin.init(gen)

    def qkv(self, x: torch.Tensor, rope: tuple):
        """q, k, v of ``x`` (B, S, D), q and k rotated by ``rope`` (the
        ``rope_cos_sin`` of their positions)."""
        B, S, _ = x.shape
        cfg, hd = self.cfg, self.cfg.head_dim_
        q = self.wq(x).reshape(B, S, cfg.num_heads, hd)
        k = self.wk(x).reshape(B, S, cfg.num_kv_heads, hd)
        v = self.wv(x).reshape(B, S, cfg.num_kv_heads, hd)
        return rotate(q, *rope), rotate(k, *rope), v


class DecoderLayer(nn.Module):
    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.ln1 = Norm(cfg.d_model, cfg.norm, cfg.norm_eps, device=device)
        self.attn = Attention(cfg, device=device)
        self.ln2 = Norm(cfg.d_model, cfg.norm, cfg.norm_eps, device=device)
        self.mlp = MLP(cfg.d_model, cfg.d_ff, gated=cfg.mlp_gated, act=cfg.act, device=device)

    def init(self, gen: torch.Generator) -> None:
        self.ln1.init()
        self.attn.init(gen)
        self.ln2.init()
        self.mlp.init(gen)


class DenseLM(nn.Module):
    """The dense family's model. Built with ``generator=None`` its parameters
    are left unset for the caller to fill (``convert.params_from_reference``);
    with a generator they are drawn from the reference's distributions. Call
    :meth:`prepare` after the parameters are set (``registry.build`` and
    ``convert.params_from_reference`` do)."""

    #: the family served, and its layer's module (a subclass sets both)
    FAMILY, LAYER = "dense", DecoderLayer
    #: the rank's mesh, and the decode slot (``registry.build`` sets both)
    mesh = None
    decode_attn_fn = None

    def __init__(self, cfg: ModelConfig, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if cfg.family != self.FAMILY:
            raise ValueError(f"{type(self).__name__} serves the {self.FAMILY} family, "
                             f"not {cfg.family!r}")
        cfg.validate()
        self.cfg = cfg
        self.attn_impl = cfg.attn_impl
        self.embed = Embedding(cfg.vocab_padded, cfg.d_model, device=device)
        self.layers = nn.ModuleList(self._layer(i, device) for i in range(cfg.num_layers))
        self.final_norm = Norm(cfg.d_model, cfg.norm, cfg.norm_eps, device=device)
        self.lm_head = (None if cfg.tie_embeddings
                        else Linear(cfg.d_model, cfg.vocab_padded, device=device))
        self.layout: Optional[Layout] = None  # set by shard()
        if generator is not None:
            self.init_weights(generator)
            self.prepare()

    def _layer(self, idx: int, device) -> nn.Module:
        """Layer ``idx``'s module (a family with unlike layers overrides it)."""
        return self.LAYER(self.cfg, device=device)

    def stacks(self) -> dict:
        """Prefix -> count of the per-layer parameters that the reference
        stacks on a leading axis (``stacking.stack_layers``)."""
        return {"layers": self.cfg.num_layers}

    def init_weights(self, generator: torch.Generator) -> "DenseLM":
        """Draw every parameter from the reference's distributions."""
        self.embed.init(generator)
        for layer in self.layers:
            layer.init(generator)
        self.final_norm.init()
        if self.lm_head is not None:
            self.lm_head.init(generator)
        return self

    def prepare(self) -> "DenseLM":
        """Make the bfloat16 copies the serving forward multiplies with (of
        every submodule that keeps some: ``Linear``, ``Embedding``, the MoE
        expert banks)."""
        for m in self.modules():
            if m is not self and hasattr(m, "prepare"):
                m.prepare()
        return self

    def release(self) -> "DenseLM":
        """Drop the serving copies, for training: every forward then casts
        the float32 weights inside the graph."""
        for m in self.modules():
            if m is not self and hasattr(m, "release"):
                m.release()
        return self

    # -- training ----------------------------------------------------------

    def shard(self, layout: Layout) -> "DenseLM":
        """Keep only this rank's block of every parameter (``layout.local``);
        the training forward then gathers them (``loss``). Serving needs the
        full parameters of an unsharded model."""
        with torch.no_grad():
            for name, p in self.named_parameters():
                if tuple(p.shape) != layout.shapes[name]:
                    raise ValueError(f"{name}: shape {tuple(p.shape)}, the layout's "
                                     f"{layout.shapes[name]}")
                p.data = layout.local(name, p.data).clone()
        self.layout = layout
        return self

    def _gathered(self, module: nn.Module, prefix: str):
        return self.layout.gathered(module, prefix) if self.layout is not None else nullcontext()

    def _layer_static(self, idx: int) -> dict:
        """The body's keywords for layer ``idx`` (a family with segments
        overrides it)."""
        return {}

    def _train_layer(self, layer: DecoderLayer, x: torch.Tensor, rope: tuple) -> torch.Tensor:
        cfg = self.cfg
        B, S, _ = x.shape
        q, k, v = layer.attn.qkv(layer.ln1(x), rope)
        o = attn.attention(q, k, v, impl=self.attn_impl, causal=True,
                           window=cfg.sliding_window, chunk=cfg.attn_chunk)
        h = x + layer.attn.wo(o.reshape(B, S, -1))
        return h + layer.mlp(layer.ln2(h))

    def _check_trained(self) -> None:
        """Raise unless the port trains this model's family: the serving-only
        families inherit this training forward but not its layer body."""
        from repro_torch.models.registry import TRAINED

        if self.FAMILY not in TRAINED:
            raise NotImplementedError(
                f"training the {self.FAMILY!r} family is not ported (ROADMAP §A item 7b); "
                f"the port trains {TRAINED}")

    def hidden_states(self, tokens: torch.Tensor) -> torch.Tensor:
        """tokens (B, S) -> final hidden states (B, S, D), bfloat16. A sharded
        model gathers each layer's parameters for its body; the caller
        gathers the embedding and the final norm (``loss`` does)."""
        self._check_trained()
        cfg = self.cfg
        x = self.embed(tokens)
        rope = rope_cos_sin(torch.arange(tokens.shape[1], device=x.device), cfg.head_dim_,
                            cfg.rope_theta)
        gathered = (None if self.layout is None
                    else lambda i: self._gathered(self.layers[i], f"layers.{i}."))
        x = apply_stack(self.layers, x,
                        lambda layer, h, **kw: self._train_layer(layer, h, rope, **kw),
                        remat_policy=cfg.remat, static=self._layer_static, gathered=gathered)
        return self.final_norm(x)

    def head_weight(self) -> torch.Tensor:
        """(D, vocab_padded) float32: the tied table's transpose or the head."""
        return self.embed.table.T if self.lm_head is None else self.lm_head.w

    def loss(self, batch: dict, *, loss_chunk: Optional[int] = None) -> torch.Tensor:
        """The mean next-token cross-entropy of ``batch`` (``tokens``,
        ``labels``: (B, S) integers)."""
        self._check_trained()
        cfg = self.cfg
        if self.embed.table16 is not None:
            raise RuntimeError("the model holds its serving copies; release() it to train")
        # a sharded model gathers the embedding, the final norm and an untied
        # head once for the whole loss
        with ExitStack() as stack:
            for name in ("embed", "final_norm", "lm_head"):
                if getattr(self, name) is not None:
                    stack.enter_context(self._gathered(getattr(self, name), f"{name}."))
            h = self.hidden_states(batch["tokens"])
            chunk = loss_chunk if loss_chunk is not None else cfg.loss_chunk
            return chunked_lm_loss(h, self.head_weight(), batch["labels"], chunk=chunk,
                                   real_vocab=cfg.vocab_size)

    @property
    def device(self) -> torch.device:
        return self.embed.table.device

    def _logits(self, x_last: torch.Tensor) -> torch.Tensor:
        """(B, D) bfloat16 -> (B, vocab_padded) bfloat16 logits, the padded
        columns at -1e30."""
        if self.lm_head is None:
            logits = x_last @ self.embed.table16.T
        else:
            logits = x_last @ self.lm_head.w16
        return mask_padded_vocab(logits, self.cfg.vocab_size)

    def init_cache(self, batch: int, capacity: int) -> dict:
        cfg = self.cfg
        shape = (cfg.num_layers, batch, capacity, cfg.num_kv_heads, cfg.head_dim_)
        return {"k": torch.zeros(shape, dtype=COMPUTE, device=self.device),
                "v": torch.zeros(shape, dtype=COMPUTE, device=self.device),
                "len": 0}

    def _ffn(self, layer: nn.Module, h: torch.Tensor, batch_split: int = 1) -> torch.Tensor:
        """The serving layer's feed-forward branch on the residual ``h``; a
        row-local one ignores ``batch_split``."""
        return layer.mlp(layer.ln2(h))

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor, patches: Optional[torch.Tensor] = None, *,
                batch_split: int = 1):
        """Process the whole prompt ``(B, S)`` (its first P embeddings
        replaced by ``patches`` ``(B, P, D)`` where given); return the cache
        of its S positions and the last position's logits
        ``(B, vocab_padded)``. On a mesh, ``tokens`` may be this rank's
        block of ``batch_split`` blocks of the global batch's rows (a
        sharded serve step's): the moe family's dispatch routes the global
        batch, the other layers are row-local."""
        cfg = self.cfg
        B, S = tokens.shape
        x = self.embed(tokens)
        if patches is not None:
            x = torch.cat([patches.to(x.dtype), x[:, patches.shape[1]:]], dim=1)
        rope = rope_cos_sin(torch.arange(S, device=x.device), cfg.head_dim_, cfg.rope_theta)
        ks, vs = [], []
        for layer in self.layers:
            q, k, v = layer.attn.qkv(layer.ln1(x), rope)
            o = attn.attention(q, k, v, impl=self.attn_impl, causal=True,
                               window=cfg.sliding_window, chunk=cfg.attn_chunk)
            x = x + layer.attn.wo(o.reshape(B, S, -1))
            x = x + self._ffn(layer, x, batch_split)
            ks.append(k.to(COMPUTE))
            vs.append(v.to(COMPUTE))
        x = self.final_norm(x)
        cache = {"k": torch.stack(ks), "v": torch.stack(vs), "len": S}
        return cache, self._logits(x[:, -1])

    def grow_cache(self, cache: dict, extra: int) -> dict:
        """The cache with ``extra`` more (zero) positions, for generation."""
        return grow_cache(cache, extra)

    @torch.no_grad()
    def decode_step(self, cache: dict, tokens: torch.Tensor, attn_fn=None, *,
                    batch_split: int = 1):
        """One token per row, ``tokens`` ``(B, 1)``, against the cache: its K
        and V are written at position ``cache["len"]`` and the token attends
        to ``len + 1`` entries through the slot ``attn_fn`` (the model's
        ``decode_attn_fn`` where None). The cache's tensors are updated in
        place (the reference returns new arrays); the returned cache shares
        them. ``batch_split`` as for :meth:`prefill`."""
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
        for i, layer in enumerate(self.layers):
            q, k, v = layer.attn.qkv(layer.ln1(x), rope)
            slot.write(cache["k"][i], k, pos)
            slot.write(cache["v"][i], v, pos)
            o = slot(q, cache["k"][i], cache["v"][i], pos + 1, cfg.sliding_window)
            x = x + layer.attn.wo(o.reshape(B, 1, -1))
            x = x + self._ffn(layer, x, batch_split)
        x = self.final_norm(x)
        return {"k": cache["k"], "v": cache["v"], "len": pos + 1}, self._logits(x[:, -1])


def grow_cache(cache: dict, extra: int) -> dict:
    """The cache with ``extra`` more (zero) positions, for generation."""
    pad = (0, 0, 0, 0, 0, extra)
    return {"k": torch.nn.functional.pad(cache["k"], pad),
            "v": torch.nn.functional.pad(cache["v"], pad), "len": cache["len"]}


class VlmLM(DenseLM):
    """The vlm family's model (phi-3-vision): the dense model, served with
    the frontend's patch embeddings (``prefill(tokens, patches)``); decode is
    the dense decode."""

    FAMILY = "vlm"
