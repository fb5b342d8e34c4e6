"""Hymba: hybrid-head LM, attention and SSM branches side by side in every
layer (arXiv:2411.13676).

The counterpart of ``src/repro/models/hymba.py``. Training:
``HymbaLM.loss(batch)`` (the reference's ``loss_fn``), through
``hidden_states`` with hymba's own layer (``hymba_layer``: both branches,
the sliding window by the reference's ``segments``). Serving:
``HymbaLM.prefill(tokens) -> (cache, logits_last)`` and
``HymbaLM.decode_step(cache, tokens) -> (cache, logits)``. Layers are unrolled
because their caches differ: sliding-window layers keep a ring buffer of
``min(window, capacity)`` K/V entries, the global layers (``cfg.global_layers``)
the full K/V, and every layer its SSM state (``ssm_h`` float32,
``ssm_conv``). The cache is ``{"layers": [{"k", "v", "ssm_h", "ssm_conv"}, ...],
"len": int}``.

Decode attends over a ring by count, ``min(pos + 1, cap)`` entries, with no
window mask, as the reference does; the KV-partition slot (``attn_fn``)
serves the global layers only, and the rings stay local
(``src/repro/models/hymba.py:127-130``): slot order does not matter to the
softmax, and a ring of ``cap`` slots holds the last ``cap`` positions. A ring
made by a prompt shorter than the window has ``cap = S`` slots, so decode
overwrites position 0 although it is still inside the window: a quirk of
the reference that the port keeps.

On a mesh whose ``model`` axis has more than one rank the layer splits its
compute over it (``pshard.Split``): the SSM branch on the rank's d_in/|model|
channels, the MLP on its d_ff/|model|, and the attention on its heads where
|model| divides H (hymba-1.5b's 25 heads do not: there every rank computes
every head). The two branches' partial outputs are summed over ``model`` in
one collective, side by side, before ``fuse`` normalises them; both enter
through one "f". Where |model| divides S the residual is sequence-parallel
(``Split.seq``): the norms (``ln1``, the fusion norms ``gn_attn`` and
``gn_ssm``, ``ln2``) and the residual run on the rank's positions, one
gather over S feeds both branches (the SSM's time recurrence reads every
position: its ``x_proj`` sum stays the plain one over all S), the split
branches' partials are reduce-scattered to the rank's positions side by
side, and a branch computed whole (hymba-1.5b's 25 heads in training, the
attention in serving's sequence mode) keeps its own positions. On a serving
mesh the rings are laid out by
``serving.steps.cache_shardings``: by KV heads in heads mode (the ring
attends the rank's heads, no collective), by slots in sequence mode (the
rank holds ring slots ``[r·cap/m, (r+1)·cap/m)``, and ``decode_step``'s
``ring_fn`` attends them by count with the flash-decode combine over
``model``, ``comm.kvshard.SeqShardedDecode``).

Two Selects can be switched on a built model: ``attn_impl`` (prefill
attention, ``pallas`` = the Hopper flash-attention kernel) and ``ssm_impl``
(the SSM branch's whole-sequence scan, ``pallas`` = the Hopper kernel
``selective_scan``, by default, once a layer in prefill and in each decode
step; ``jnp`` = its plain version).
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import ssm
from repro_torch.models.layers import COMPUTE, MLP, Norm, rope_cos_sin
from repro_torch.models.pshard import Split
from repro_torch.models.transformer import Attention, DenseLM
from repro_torch.obs.ranges import spanned


class HymbaLayer(nn.Module):
    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        norm = lambda: Norm(cfg.d_model, cfg.norm, cfg.norm_eps, device=device)  # noqa: E731
        self.ln1 = norm()
        self.attn = Attention(cfg, device=device)
        self.ssm = ssm.SSM(cfg.d_model, cfg.ssm, device=device)
        self.gn_attn = norm()
        self.gn_ssm = norm()
        self.ln2 = norm()
        # the reference's hymba_layer_init makes a gated MLP whatever mlp_gated says
        self.mlp = MLP(cfg.d_model, cfg.d_ff, gated=True, act=cfg.act, device=device)

    def init(self, gen: torch.Generator) -> None:
        for norm in (self.ln1, self.gn_attn, self.gn_ssm, self.ln2):
            norm.init()
        self.attn.init(gen)
        self.ssm.init(gen)
        self.mlp.init(gen)

    def fuse(self, x: torch.Tensor, a: torch.Tensor, s: torch.Tensor,
             split=None) -> torch.Tensor:
        """The residual stream after the layer, from its input ``x`` and the
        two branches' whole outputs: their normalised mean, then the MLP
        (split by ``split``)."""
        x = x + 0.5 * (self.gn_attn(a) + self.gn_ssm(s))
        return x + self.mlp(self.ln2(x), split)


class HymbaLM(DenseLM):
    """The hybrid family's model: ``DenseLM``'s embedding, final norm, head,
    parameter drawing, ``prepare``, sharding and loss, with hymba's layers,
    training layer body, caches, prefill and decode."""

    FAMILY, LAYER = "hybrid", HymbaLayer
    #: the SSM scan's Select, switchable on a built model like ``attn_impl``
    ssm_impl = "pallas"

    def _is_global(self, idx: int) -> bool:
        return idx in self.cfg.global_layers

    # -- training ----------------------------------------------------------

    def _layer_static(self, idx: int) -> dict:
        """The reference's ``segments``: full causal attention in the global
        layers, the sliding window elsewhere."""
        return {"window": None if self._is_global(idx) else self.cfg.sliding_window}

    def _remat_group(self) -> int:
        """One layer per checkpoint: the reference's hymba stack takes no
        ``remat_group``."""
        return 1

    @staticmethod
    def _inputs(xn: torch.Tensor, split: Optional[Split]) -> tuple:
        """The attention's and the SSM branch's input: ``xn``, or under
        ``split`` one "f" of it for the branches that split; under its
        ``seq``, one gather over S for both (each reads every position)."""
        if split is None:
            return xn, xn
        if split.seq is not None:
            xg = split.enter(xn)
            return xg, xg
        heads, chans = split.heads is not None, split.d_in is not None
        xin = split.enter(xn) if heads or chans else xn
        return (xin if heads else xn), (xin if chans else xn)

    @staticmethod
    def _wo(layer: HymbaLayer, o: torch.Tensor, split: Optional[Split]) -> torch.Tensor:
        """``wo`` of the attention's output (B, S, heads, hd): the float32
        partial output of the rank's heads under ``split``, for
        :meth:`_outputs` to sum; of a whole attention's own positions under
        a sequence split."""
        if split is not None and split.heads is not None:
            return layer.attn.wo.partial(o.reshape(o.shape[0], o.shape[1], -1))
        o = o if split is None else split.own(o)
        return layer.attn.wo(o.reshape(o.shape[0], o.shape[1], -1))

    @staticmethod
    def _outputs(a: torch.Tensor, s: torch.Tensor, split: Optional[Split]) -> tuple:
        """The branches' outputs on the residual's positions: under ``split``,
        the partial ones summed over ``model`` side by side in one collective
        (reduce-scattered under its ``seq``, where a whole SSM branch keeps
        its own positions)."""
        if split is None:
            return a, s
        heads, chans = split.heads is not None, split.d_in is not None
        if not chans:
            s = split.own(s)
        if heads and chans:
            return split.reduce(a, s)
        return (split.reduce(a) if heads else a), (split.reduce(s) if chans else s)

    def _train_layer(self, layer: HymbaLayer, x: torch.Tensor, rope: tuple,
                     split: Optional[Split] = None, *, window) -> torch.Tensor:
        """The reference's ``hymba_layer``: both branches on the normed input,
        fused. The SSM branch trains through the plain scan (``jnp``), as the
        reference does: the scan kernel has no backward, so ``ssm_impl``
        (serving's Select) never reaches this path."""
        cfg = self.cfg
        x_attn, x_ssm = self._inputs(layer.ln1(x), split)
        q, k, v = layer.attn.qkv(x_attn, rope)
        o = attn.attention(q, k, v, impl=self.attn_impl, causal=True, window=window,
                           chunk=cfg.attn_chunk)
        a = self._wo(layer, o, split)
        s, _ = ssm.ssm_apply(layer.ssm, x_ssm, cfg.ssm, impl="jnp", split=self._chans(split))
        return layer.fuse(x, *self._outputs(a, s, split), split)

    @staticmethod
    def _chans(split: Optional[Split]) -> Optional[Split]:
        """``split`` where it splits the SSM's channels, else None; with the
        residual whole, for the ``x_proj`` sum over every position."""
        return split.whole_seq() if split is not None and split.d_in is not None else None

    def _kv_capacity(self, idx: int, capacity: int) -> int:
        return capacity if self._is_global(idx) else min(self.cfg.sliding_window, capacity)

    def init_cache(self, batch: int, capacity: int) -> dict:
        cfg, dev = self.cfg, self.device
        layers = []
        for idx in range(cfg.num_layers):
            shape = (batch, self._kv_capacity(idx, capacity), cfg.num_kv_heads, cfg.head_dim_)
            st = ssm.init_state(batch, cfg.d_model, cfg.ssm, device=dev)
            layers.append({"k": torch.zeros(shape, dtype=COMPUTE, device=dev),
                           "v": torch.zeros(shape, dtype=COMPUTE, device=dev),
                           "ssm_h": st.h, "ssm_conv": st.conv})
        return {"layers": layers, "len": 0}

    def grow_cache(self, cache: dict, extra: int) -> dict:
        """The cache with ``extra`` more (zero) K/V positions in the global
        layers, for generation; the rings keep their size. Its K/V tensors
        are new, as the dense family's are, so decoding into it (in place)
        leaves the given cache as it was."""
        pad = (0, 0, 0, 0, 0, extra)
        layers = []
        for i, c in enumerate(cache["layers"]):
            grow = self._is_global(i)
            layers.append(dict(c, **{n: torch.nn.functional.pad(c[n], pad) if grow
                                     else c[n].clone() for n in ("k", "v")}))
        return {"layers": layers, "len": cache["len"]}

    @spanned("serve.prefill")
    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor):
        """Process the whole prompt ``(B, S)``; return the cache of its S
        positions (the last ``window`` of them, ring-aligned, in the
        sliding-window layers) and the last position's logits
        ``(B, vocab_padded)``."""
        cfg = self.cfg
        S = tokens.shape[1]
        split = self.split.at(S) if self.split is not None else None
        x = self._embed_inputs(tokens, None, split)
        rope = rope_cos_sin(torch.arange(S, device=x.device), cfg.head_dim_, cfg.rope_theta)
        layers = []
        for idx, layer in enumerate(self.layers):
            is_global = self._is_global(idx)
            x_attn, x_ssm = self._inputs(layer.ln1(x), split)
            q, k, v = layer.attn.qkv(x_attn, rope)
            o = attn.attention(q, k, v, impl=self.attn_impl, causal=True,
                               window=None if is_global else cfg.sliding_window,
                               chunk=cfg.attn_chunk)
            a = self._wo(layer, o, split)
            s, st = ssm.ssm_apply(layer.ssm, x_ssm, cfg.ssm, impl=self.ssm_impl,
                                  split=self._chans(split))
            x = layer.fuse(x, *self._outputs(a, s, split), split)
            kk, vv = k.to(COMPUTE), v.to(COMPUTE)
            cap = self._kv_capacity(idx, S)
            if not is_global and S > cap:
                # keep the last cap entries, ring-aligned so that slot j holds
                # the position p with p % cap == j
                roll = (S - cap) % cap
                kk = torch.roll(kk[:, S - cap:], roll, dims=1)
                vv = torch.roll(vv[:, S - cap:], roll, dims=1)
            layers.append({"k": kk, "v": vv, "ssm_h": st.h, "ssm_conv": st.conv})
        return {"layers": layers, "len": S}, self._last_logits(x, split)

    @torch.no_grad()
    def decode_step(self, cache: dict, tokens: torch.Tensor, attn_fn=None, ring_fn=None):
        """One token per row, ``tokens`` ``(B, 1)``, against the cache: its K
        and V are written at position ``len`` of a global layer and at slot
        ``len % cap`` of a ring. A global layer attends through the slot
        ``attn_fn`` (the model's ``decode_attn_fn`` where None), a ring
        through ``ring_fn`` (the local attention where None; a ring split over
        ``model`` passes its partition's slot), by count. The K/V tensors are
        updated in place (the reference returns new arrays); the returned
        cache shares them."""
        cfg = self.cfg
        slot = attn.decode_slot(attn_fn if attn_fn is not None else self.decode_attn_fn)
        ring = attn.decode_slot(ring_fn)
        split = self.split
        pos = int(cache["len"])
        x = self._embed_inputs(tokens, None, split)
        rope = rope_cos_sin(torch.arange(pos, pos + 1, device=x.device), cfg.head_dim_,
                            cfg.rope_theta)
        layers = []
        for idx, (layer, c) in enumerate(zip(self.layers, cache["layers"])):
            kv = slot if self._is_global(idx) else ring
            cap = kv.capacity(c["k"])
            if self._is_global(idx):
                if pos >= cap:
                    raise ValueError(f"layer {idx} holds {cap} positions, all used; "
                                     "grow the cache before decoding")
                write = pos
            else:
                write = pos % cap  # ring buffer
            x_attn, x_ssm = self._inputs(layer.ln1(x), split)
            q, k, v = layer.attn.qkv(x_attn, rope)
            kv.write(c["k"], k, write)
            kv.write(c["v"], v, write)
            o = kv(q, c["k"], c["v"], min(pos + 1, cap), None)
            a = self._wo(layer, o, split)
            s, st = ssm.ssm_decode(layer.ssm, x_ssm, cfg.ssm,
                                   ssm.SSMState(h=c["ssm_h"], conv=c["ssm_conv"]),
                                   impl=self.ssm_impl, split=self._chans(split))
            x = layer.fuse(x, *self._outputs(a, s, split), split)
            layers.append({"k": c["k"], "v": c["v"], "ssm_h": st.h, "ssm_conv": st.conv})
        return {"layers": layers, "len": pos + 1}, self._last_logits(x, split)
