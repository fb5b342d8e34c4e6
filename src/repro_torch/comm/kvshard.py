"""KV-cache partitioning chunnels for decode (a Bertha routing Select).

The counterpart of ``src/repro/comm/kvshard.py``, on ``torch.distributed``:

  heads     — KV heads sharded over 'model' (only when kv_heads % |model| == 0:
              llama (8), phi-3 (32), seamless (16)). The reference's branch is
              layout-only (the partitioner splits the attention by heads);
              here the split compute is explicit: a rank holds KV heads
              ``[r·KH/m, (r+1)·KH/m)`` and attends the query heads they
              serve, ``[r·H/m, (r+1)·H/m)`` (GQA: query head h reads KV head
              h // group). A model whose compute is split over 'model'
              (``models.pshard``: dense, vlm, hybrid) computes only those
              heads of q and of the new K/V, and the slot returns the rank's
              heads of the output (``local_heads``): ``wo``'s row product
              and its sum over 'model' take the place of a gather. A family
              that computes every head (moe, audio) hands the slot all of
              them; it writes its heads of the new K/V and all-gathers the
              output over 'model' along the heads.
  sequence  — cache SEQUENCE sharded over 'model' (granite kv=1, hymba kv=5,
              qwen/mistral/dbrx kv∤16): flash-decoding — each rank computes
              partial (m, l, o) over its sequence shard, combined with a
              max all-reduce and a sum all-reduce across 'model'. Only the
              rank that owns position ``pos`` writes it.

Hazard (sequence mode and the compute split). The cache's positions are
cut over 'model' but every head is held, so a rank cannot attend its own
heads only: it would need the other ranks' heads of its positions. In
sequence mode a split model keeps its attention block whole (every rank
computes every head of q, k and v, and the flash-decode combine runs over
them); only its MLP and its SSM channels split. hymba's rings, cut by slots
in sequence mode, attend through this branch too: the owner of slot
``pos % cap`` writes it, and the rank attends its slots by count
(``kv_len = min(pos + 1, cap)``, no window mask).

Each branch is a decode slot (``models.attention.LocalDecode``): called as
``attn_fn(q, k_cache, v_cache, kv_len, window)`` on this rank's shard of the
cache, with the ``capacity`` and ``write`` that its partition changes. Every
family's ``decode_step`` takes one (``registry.build(decode_attn_fn=...)``).

Decode is memory-bound; sequence sharding spreads the dominant HBM stream
(the cache read) across all chips regardless of kv-head count. The combine
is plain PyTorch, as the reference's is plain ``jnp``: no kernel sits here.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.comm import collectives
from repro_torch.comm.chunnels import StepChunnel
from repro_torch.core.capability import CapabilitySet
from repro_torch.models.attention import LocalDecode, decode_attention_local

NEG_INF = -1e30


def flash_decode_local(q, k_loc, v_loc, start, kv_len, window=None):
    """Partial attention over a local cache shard.

    q: (B,1,H,hd); k_loc/v_loc: (B,S_loc,KH,hd); start: global pos of
    shard[0]; kv_len an int or a (B,) tensor. Returns (o (B,H,hd), l (B,H),
    m (B,H)), float32. The scores are bfloat16 products of q and k, and P·V
    one of bfloat16 p and v, as in the reference; invalid positions are
    masked to ``NEG_INF`` and their p zeroed (a shard wholly past ``kv_len``
    gives l = 0 and o = 0)."""
    B, _, H, hd = q.shape
    S, KH = k_loc.shape[1], k_loc.shape[2]
    G = H // KH
    # the query heads that share a KV head side by side (head h = kh·G + j)
    qg = q.to(torch.bfloat16).reshape(B, KH, G, hd)
    s = torch.einsum("bkgd,bskd->bkgs", qg, k_loc.to(torch.bfloat16)).float() * hd**-0.5
    kpos = start + torch.arange(S, device=q.device)
    n = kv_len.to(q.device).reshape(-1, 1) if torch.is_tensor(kv_len) else kv_len
    valid = kpos[None, :] < n
    if window is not None:
        valid &= kpos[None, :] >= n - window
    invalid = ~valid[:, None, None, :]
    s = s.masked_fill(invalid, NEG_INF)
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None]).masked_fill(invalid, 0.0)  # kill exp(0) of all-masked rows
    l = p.sum(dim=-1)
    o = torch.einsum("bkgs,bskd->bkgd", p.to(torch.bfloat16),
                     v_loc.to(torch.bfloat16)).float()
    return o.reshape(B, H, hd), l.reshape(B, H), m.reshape(B, H)


class SeqShardedDecode(LocalDecode):
    """The sequence branch's slot on this rank: its shard of S_loc positions
    starts at ``index(axis) * S_loc``."""

    def __init__(self, mesh, axis: str = "model"):
        self.mesh, self.axis = mesh, axis
        self.n, self.index = mesh.shape[axis], mesh.coords[axis]

    def capacity(self, k_cache: torch.Tensor) -> int:
        return k_cache.shape[1] * self.n

    def write(self, cache: torch.Tensor, new: torch.Tensor, pos: int) -> None:
        s_loc = cache.shape[1]
        if pos // s_loc == self.index:
            cache[:, pos - self.index * s_loc] = new[:, 0].to(cache.dtype)

    def __call__(self, q, k_cache, v_cache, kv_len, window=None):
        B, _, H, hd = q.shape
        o, l, m = flash_decode_local(q, k_cache, v_cache, self.index * k_cache.shape[1],
                                     kv_len, window)
        m_g = collectives.all_reduce_max(m, self.mesh, self.axis)
        corr = torch.exp(m - m_g)
        # l·corr and o·corr summed in one all-reduce (the reference's two psums)
        part = torch.cat([o * corr[..., None], (l * corr)[..., None]], dim=-1)
        tot = collectives.all_reduce_sum(part, self.mesh, self.axis)
        out = tot[..., :hd] / tot[..., hd:].clamp_min(1e-20)
        return out[:, None].to(q.dtype)  # (B,1,H,hd)


class HeadShardedDecode(LocalDecode):
    """The heads branch's slot on this rank: it holds KV heads
    ``[index·KH_loc, (index+1)·KH_loc)`` of every position. With
    ``local_heads`` (a split model's) q and the new K/V are the rank's heads
    already and the output stays the rank's heads; else they are every head,
    and the output is all-gathered over ``axis``."""

    def __init__(self, mesh, axis: str = "model", local_heads: bool = False):
        self.mesh, self.axis, self.local_heads = mesh, axis, local_heads
        self.n, self.index = mesh.shape[axis], mesh.coords[axis]

    def write(self, cache: torch.Tensor, new: torch.Tensor, pos: int) -> None:
        if self.local_heads:
            return super().write(cache, new, pos)
        kh = cache.shape[2]
        cache[:, pos] = new[:, 0, self.index * kh:(self.index + 1) * kh].to(cache.dtype)

    def __call__(self, q, k_cache, v_cache, kv_len, window=None):
        if self.local_heads:
            return decode_attention_local(q, k_cache, v_cache, kv_len, window=window)
        h_loc = q.shape[2] // self.n
        q_loc = q[:, :, self.index * h_loc:(self.index + 1) * h_loc]
        o = decode_attention_local(q_loc, k_cache, v_cache, kv_len, window=window)
        return collectives.gather_dim(o, self.mesh, self.axis, 2)  # (B,1,H,hd)


def make_seq_sharded_decode(mesh, axis: str = "model") -> SeqShardedDecode:
    """``attn_fn(q, k_loc, v_loc, kv_len, window)`` with the cache's sequence
    split over ``axis`` and the flash-decode combine."""
    return SeqShardedDecode(mesh, axis)


def make_head_sharded_decode(mesh, axis: str = "model", *,
                             local_heads: bool = False) -> HeadShardedDecode:
    """``attn_fn(q, k_loc, v_loc, kv_len, window)`` with the cache's KV heads
    split over ``axis`` (``local_heads``: q is the rank's heads, and so is
    the output)."""
    return HeadShardedDecode(mesh, axis, local_heads)


# ---------------------------------------------------------------------------
# Chunnel wrappers (negotiated; compositional capability — routing-style)
# ---------------------------------------------------------------------------


@dataclass
class KVHeadSharded(StepChunnel):
    axis: str = "model"

    @property
    def name(self):
        return "KVHeadSharded"

    def capabilities(self):
        return CapabilitySet.compose(f"kvshard:heads@{self.axis}")

    def attn_fn(self, mesh, *, local_heads: bool = False) -> HeadShardedDecode:
        return make_head_sharded_decode(mesh, self.axis, local_heads=local_heads)

    def apply(self, tree, state, ctx):
        return tree, state  # the cache's layout and the slot carry the branch


@dataclass
class KVSeqSharded(StepChunnel):
    axis: str = "model"

    @property
    def name(self):
        return "KVSeqSharded"

    def capabilities(self):
        return CapabilitySet.compose(f"kvshard:sequence@{self.axis}")

    def attn_fn(self, mesh) -> SeqShardedDecode:
        return make_seq_sharded_decode(mesh, self.axis)

    def apply(self, tree, state, ctx):
        return tree, state


def pick_kv_chunnel(cfg, mesh, sharding_cfg) -> StepChunnel:
    from repro_torch.models.sharding import kv_partition_mode

    mode = kv_partition_mode(cfg, mesh, sharding_cfg)
    return KVHeadSharded() if mode == "heads" else KVSeqSharded()
