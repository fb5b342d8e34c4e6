"""Dense GQA transformer LM (llama / qwen / mistral / granite), and the vlm
family (phi-3-vision) that serves and trains through it.

The counterpart of ``src/repro/models/transformer.py``. Training:
``DenseLM.hidden_states(tokens, patches=None)`` and ``DenseLM.loss(batch)``
(the reference's ``loss_fn``, the vlm batch's ``patches`` over the first
positions), on a model whose serving copies are released
(:meth:`DenseLM.release`) so that every weight is cast inside the autograd
graph; each layer, or each run of ``cfg.remat_group`` layers, is recomputed
in backward under ``cfg.remat`` (``stacking.remat``).
A model sharded over a mesh (:meth:`DenseLM.shard`) holds only its rank's
block of each parameter and gathers what the training forward reads
(``sharding.Layout``). On a mesh whose ``model`` axis has more than one rank
the dense and vlm families split their compute over it (``pshard.Split``;
the moe, ssm and audio families' models reuse these helpers):
a rank computes its query heads and the KV heads they read (where |model|
divides H), and its d_ff/|model| channels of the MLP; the row products'
partial outputs (``wo``, ``down``) are summed over ``model``. The split's
parameters keep their ``model`` block and are gathered over the batch axes
only. Where |model| divides S the residual stream is sequence-parallel
(``Split.seq``): each rank holds its S/|model| positions, the norms run on
them, the blocks gather their input over S and reduce-scatter their
outputs; and where it divides ``vocab_padded`` the embedding and the head
are vocabulary-parallel (``Split.vocab``: the rank's rows of the table and
columns of the head, the loss ``layers.vocab_parallel_lm_loss``). Serving
sets the split on the model (``split``, by ``serving.steps.lay_out``; its
attention is whole in sequence mode); a prefill's last position comes from
the rank that holds it, and the ranks' logits are gathered.
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

from contextlib import ExitStack, contextmanager, nullcontext
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
    vocab_parallel_lm_loss,
)
from repro_torch.models.pshard import Split, model_split
from repro_torch.models.sharding import Layout
from repro_torch.models.stacking import apply_stack
from repro_torch.obs.ranges import spanned


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
        hd = self.cfg.head_dim_
        # every head, or this rank's under a compute split (its weights' blocks)
        q = self.wq(x).reshape(B, S, -1, hd)
        k = self.wk(x).reshape(B, S, -1, hd)
        v = self.wv(x).reshape(B, S, -1, hd)
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
    #: the serving forward's compute split over ``model`` (``pshard.Split``;
    #: ``serving.steps.lay_out`` sets it), None for the whole compute
    split = None

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

    def _gathered(self, module: nn.Module, prefix: str, reads=None):
        return (self.layout.gathered(module, prefix, reads) if self.layout is not None
                else nullcontext())

    def _layer_static(self, idx: int) -> dict:
        """The body's keywords for layer ``idx`` (a family with segments
        overrides it)."""
        return {}

    def _remat_group(self) -> int:
        """The layers per checkpoint: ``cfg.remat_group`` for a scanned stack,
        as the reference's ``forward`` passes it (a family whose reference
        stack takes none overrides this)."""
        return self.cfg.remat_group if self.cfg.scan_layers else 1

    def _attn_residual(self, layer: nn.Module, x: torch.Tensor, rope: tuple,
                       split: Optional[Split] = None) -> torch.Tensor:
        """The training layer's residual stream after its attention block
        (on the rank's heads under ``split``)."""
        cfg = self.cfg
        q, k, v = layer.attn.qkv(self._attn_in(layer.ln1(x), split), rope)
        o = attn.attention(q, k, v, impl=self.attn_impl, causal=True,
                           window=cfg.sliding_window, chunk=cfg.attn_chunk)
        return x + self._attn_out(layer.attn, o, split)

    @staticmethod
    def _attn_in(h: torch.Tensor, split: Optional[Split]) -> torch.Tensor:
        """The attention's input from the normed residual ``h``: under
        ``split``, through its "f" for the rank's heads, or gathered over S
        for an attention computed whole."""
        if split is None:
            return h
        return split.enter(h) if split.heads is not None else split.gather(h)

    @staticmethod
    def _attn_out(att: Attention, o: torch.Tensor, split: Optional[Split]) -> torch.Tensor:
        """``att.wo`` of the attention's output (B, S, heads, hd): a row
        product summed over ``model`` when ``o`` holds the rank's heads; of
        the rank's positions of a whole attention under a sequence split."""
        if split is None or split.heads is None:
            o = o if split is None else split.own(o)
            return att.wo(o.reshape(o.shape[0], o.shape[1], -1))
        B, S = o.shape[:2]
        return split.reduce(att.wo.partial(o.reshape(B, S, -1)))

    def _train_layer(self, layer: DecoderLayer, x: torch.Tensor, rope: tuple,
                     split: Optional[Split] = None) -> torch.Tensor:
        h = self._attn_residual(layer, x, rope, split)
        return h + layer.mlp(layer.ln2(h), split)

    def _train_split(self, S: int) -> Optional[Split]:
        """The training forward's compute split on ``S`` positions: the
        family's, on the mesh of the model's layout."""
        split = None if self.layout is None else model_split(self.cfg, self.layout.mesh)
        return None if split is None else split.at(S)

    def _train_stack(self, carry, S: int, body, split: Optional[Split] = None):
        """``carry`` (the residual stream, or a tuple that starts with it)
        through every layer by ``body(layer, carry, rope, split, **static)``,
        as the reference's ``apply_stack``: each layer's parameters gathered
        for its body on a sharded model (under the compute split ``split``,
        those it splits keep their ``model`` block), checkpointed under
        ``cfg.remat``. The rotation covers all S positions: a block that
        reads them gathers its input over S first."""
        cfg = self.cfg
        rope = rope_cos_sin(torch.arange(S, device=self.device), cfg.head_dim_, cfg.rope_theta)
        reads = split.reads() if split is not None else None
        gathered = (None if self.layout is None else
                    lambda i: self.layout.gathered(self.layers[i], f"layers.{i}.", reads))
        return apply_stack(self.layers, carry,
                           lambda layer, c, **kw: body(layer, c, rope, split, **kw),
                           remat_policy=cfg.remat, remat_group=self._remat_group(),
                           static=self._layer_static, gathered=gathered)

    def _embed_inputs(self, tokens: torch.Tensor, patches: Optional[torch.Tensor] = None,
                      split: Optional[Split] = None) -> torch.Tensor:
        """The token embeddings (B, S, D), the first P replaced by ``patches``
        (B, P, D) where given (the reference's ``extra_embeds``). P must not
        exceed S: the reference's ``x[:, P:]`` would give a sequence of P
        positions against S labels (its rope then fails to broadcast). Under
        ``split``'s vocabulary split, the rank's rows' lookups summed over
        ``model`` (``Split.embed``): under its ``seq``, the rank's positions
        (B, S/|model|, D), the patches joined at the positions they replace."""
        S = tokens.shape[1]
        if patches is not None and patches.shape[1] > S:
            raise ValueError(f"{patches.shape[1]} patch positions do not fit a sequence of "
                             f"{S}: the patches replace the first P of the S token positions")
        if split is None or split.vocab is None:
            x, first = self.embed(tokens), 0
        else:
            x = split.embed(self.embed(tokens, split.vocab))
            first = 0 if split.seq is None else split.seq.start
        if patches is None:
            return x
        k = min(max(patches.shape[1] - first, 0), x.shape[1])  # own positions < P
        if k == 0:
            return x
        return torch.cat([patches[:, first:first + k].to(x.dtype), x[:, k:]], dim=1)

    def hidden_states(self, tokens: torch.Tensor, patches: Optional[torch.Tensor] = None,
                      split: Optional[Split] = None) -> torch.Tensor:
        """tokens (B, S), and the vlm family's ``patches`` (B, P, D) over the
        first P positions -> final hidden states (B, S, D), bfloat16 (under
        ``split``'s ``seq``, the rank's positions). A sharded model gathers
        each layer's parameters for its body; the caller gathers the
        embedding and the final norm (``loss`` does)."""
        x = self._train_stack(self._embed_inputs(tokens, patches, split), tokens.shape[1],
                              self._train_layer, split)
        return self.final_norm(x)

    def head_weight(self) -> torch.Tensor:
        """(D, vocab_padded) float32: the tied table's transpose or the head."""
        return self.embed.table.T if self.lm_head is None else self.lm_head.w

    #: the top-level parameters ``loss`` gathers once for the whole loss
    HEAD = ("embed", "final_norm", "lm_head")

    def _check_released(self) -> None:
        if self.embed.table16 is not None:
            raise RuntimeError("the model holds its serving copies; release() it to train")

    @contextmanager
    def _head_gathered(self, split: Optional[Split] = None):
        """Within it, a sharded model's ``HEAD`` parameters read as their
        full tensors (under ``split``, as it reads them: the rank's rows of
        the table and columns of the head, the final norm as a shared part)."""
        with ExitStack() as stack:
            for name in self.HEAD:
                if getattr(self, name) is not None:
                    reads = split.reads(f"{name}.") if split is not None else None
                    stack.enter_context(self._gathered(getattr(self, name), f"{name}.", reads))
            yield

    def _lm_loss(self, h: torch.Tensor, labels: torch.Tensor, loss_chunk: Optional[int],
                 split: Optional[Split] = None) -> torch.Tensor:
        """The loss of the final hidden states ``h``; under ``split``'s
        vocabulary split, of the rank's columns of the logits, ``h`` entering
        through its "f" (gathered over S under its ``seq``)."""
        chunk = loss_chunk if loss_chunk is not None else self.cfg.loss_chunk
        if split is None or split.vocab is None:
            return chunked_lm_loss(h, self.head_weight(), labels, chunk=chunk,
                                   real_vocab=self.cfg.vocab_size)
        return vocab_parallel_lm_loss(split.enter(h, torch.float32), self.head_weight(), labels,
                                      split.vocab, split.mesh, chunk=chunk,
                                      real_vocab=self.cfg.vocab_size)

    def loss(self, batch: dict, *, loss_chunk: Optional[int] = None,
             batch_split: int = 1) -> torch.Tensor:
        """The mean next-token cross-entropy of ``batch`` (``tokens``,
        ``labels``: (B, S) integers; ``patches`` (B, P, D) for vlm). A
        row-local family ignores ``batch_split`` (the moe family's dispatch
        reads it)."""
        self._check_released()
        split = self._train_split(batch["tokens"].shape[1])
        with self._head_gathered(split):
            h = self.hidden_states(batch["tokens"], batch.get("patches"), split)
            return self._lm_loss(h, batch["labels"], loss_chunk, split)

    @property
    def device(self) -> torch.device:
        return self.embed.table.device

    def _logits(self, x_last: torch.Tensor, split: Optional[Split] = None) -> torch.Tensor:
        """(B, D) bfloat16 -> (B, vocab_padded) bfloat16 logits, the padded
        columns at -1e30; under ``split``'s vocabulary split, the rank's
        columns gathered over ``model``."""
        if self.lm_head is None:
            logits = x_last @ self.embed.table16.T
        else:
            logits = x_last @ self.lm_head.w16
        if split is not None and split.vocab is not None:
            logits = split.logits(logits)
        return mask_padded_vocab(logits, self.cfg.vocab_size)

    def init_cache(self, batch: int, capacity: int) -> dict:
        cfg = self.cfg
        shape = (cfg.num_layers, batch, capacity, cfg.num_kv_heads, cfg.head_dim_)
        return {"k": torch.zeros(shape, dtype=COMPUTE, device=self.device),
                "v": torch.zeros(shape, dtype=COMPUTE, device=self.device),
                "len": 0}

    def _ffn(self, layer: nn.Module, h: torch.Tensor, batch_split: int = 1,
             split: Optional[Split] = None) -> torch.Tensor:
        """The serving layer's feed-forward branch on the residual ``h``
        (split by ``split``, the call's); a row-local one ignores
        ``batch_split``."""
        return layer.mlp(layer.ln2(h), split)

    @spanned("serve.prefill")
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
        S = tokens.shape[1]
        split = self.split.at(S) if self.split is not None else None
        x = self._embed_inputs(tokens, patches, split)
        rope = rope_cos_sin(torch.arange(S, device=x.device), cfg.head_dim_, cfg.rope_theta)
        ks, vs = [], []
        for layer in self.layers:
            q, k, v = layer.attn.qkv(self._attn_in(layer.ln1(x), split), rope)
            o = attn.attention(q, k, v, impl=self.attn_impl, causal=True,
                               window=cfg.sliding_window, chunk=cfg.attn_chunk)
            x = x + self._attn_out(layer.attn, o, split)
            x = x + self._ffn(layer, x, batch_split, split)
            _keep_kv(ks, vs, k, v)
        return _stack_kv(ks, vs, S), self._last_logits(x, split)

    def _last_logits(self, x: torch.Tensor, split: Optional[Split]) -> torch.Tensor:
        """The logits of the last position of the residual ``x`` (under
        ``split``'s ``seq``, taken from the rank that holds it)."""
        row = x[:, -1] if split is None else split.last_row(x)
        return self._logits(self.final_norm(row), split)

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
        pos = int(cache["len"])
        cap = slot.capacity(cache["k"][0])
        if pos >= cap:
            raise ValueError(f"the cache holds {cap} positions, all used; "
                             "grow it before decoding")
        split = self.split
        x = self._embed_inputs(tokens, None, split)
        rope = rope_cos_sin(torch.arange(pos, pos + 1, device=x.device), cfg.head_dim_,
                            cfg.rope_theta)
        for i, layer in enumerate(self.layers):
            q, k, v = layer.attn.qkv(layer.ln1(x), rope)
            slot.write(cache["k"][i], k, pos)
            slot.write(cache["v"][i], v, pos)
            o = slot(q, cache["k"][i], cache["v"][i], pos + 1, cfg.sliding_window)
            x = x + self._attn_out(layer.attn, o, split)
            x = x + self._ffn(layer, x, batch_split, split)
        return {"k": cache["k"], "v": cache["v"], "len": pos + 1}, self._last_logits(x, split)


@spanned("model.kv_cache")
def _keep_kv(ks: list, vs: list, k: torch.Tensor, v: torch.Tensor) -> None:
    """A prefill layer's K and V, in the compute type, for the cache."""
    ks.append(k.to(COMPUTE))
    vs.append(v.to(COMPUTE))


@spanned("model.kv_cache")
def _stack_kv(ks: list, vs: list, S: int) -> dict:
    """The prefill's cache: every layer's K and V stacked on a leading axis."""
    return {"k": torch.stack(ks), "v": torch.stack(vs), "len": S}


def grow_cache(cache: dict, extra: int) -> dict:
    """The cache with ``extra`` more (zero) positions, for generation."""
    pad = (0, 0, 0, 0, 0, extra)
    return {"k": torch.nn.functional.pad(cache["k"], pad),
            "v": torch.nn.functional.pad(cache["v"], pad), "len": cache["len"]}


class VlmLM(DenseLM):
    """The vlm family's model (phi-3-vision): the dense model, served and
    trained with the frontend's patch embeddings over the first P positions
    (``prefill(tokens, patches)``, ``loss`` of a batch with ``patches``,
    which needs S >= P); decode is the dense decode."""

    FAMILY = "vlm"
