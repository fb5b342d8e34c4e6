"""Attention implementations (a Bertha Select: xla_dense | xla_chunked | pallas).

The counterpart of ``src/repro/models/attention.py``. The impl names stay the
reference's so that configs carry across unchanged. All share one contract:
  q: (B, Sq, H, hd), k/v: (B, Skv, KH, hd), H % KH == 0 (GQA)
  returns (B, Sq, H, hd)

``xla_dense``   materializes (B, H, Sq, Skv) scores in plain PyTorch.
``xla_chunked`` online-softmax loop over KV chunks in plain PyTorch, with
                bfloat16 scores as in the reference.
``pallas``      the slot of the reference's TPU flash-attention kernel; here it
                is the hand-written Hopper kernel
                (``repro_torch.kernels.flash_attention``), and its plain
                version on CPU tensors. Like the reference, it ignores
                ``chunk``, ``q_offset`` and ``kv_len``.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.flash_attention.flash_attention import flash_attention
from repro_torch.obs.ranges import spanned

NEG_INF = -1e30
IMPLS = ("xla_dense", "xla_chunked", "pallas")


def _mask_bias(qpos, kpos, *, causal: bool, window: Optional[int], kv_len) -> torch.Tensor:
    """Additive mask bias (qlen, klen) in float32."""
    ok = torch.ones(qpos.shape[0], kpos.shape[0], dtype=torch.bool, device=qpos.device)
    if causal:
        ok &= kpos[None, :] <= qpos[:, None]
    if window is not None:
        ok &= qpos[:, None] - kpos[None, :] < window
    if kv_len is not None:
        ok &= kpos[None, :] < kv_len
    zero = torch.zeros((), dtype=torch.float32, device=qpos.device)
    return torch.where(ok, zero, zero + NEG_INF)


def _expand_kv(x: torch.Tensor, group: int) -> torch.Tensor:
    """(B, S, KH, hd) -> (B, S, KH*group, hd) by repeating each kv head."""
    return x if group == 1 else x.repeat_interleave(group, dim=2)


def attention_dense(q, k, v, *, causal: bool = True, window: Optional[int] = None,
                    q_offset=0, kv_len=None) -> torch.Tensor:
    B, Sq, H, hd = q.shape
    group = H // k.shape[2]
    k = _expand_kv(k, group)
    v = _expand_kv(v, group)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * hd**-0.5
    qpos = q_offset + torch.arange(Sq, device=q.device)
    kpos = torch.arange(k.shape[1], device=q.device)
    scores = scores + _mask_bias(qpos, kpos, causal=causal, window=window, kv_len=kv_len)
    w = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", w, v)


def attention_chunked(q, k, v, *, causal: bool = True, window: Optional[int] = None,
                      chunk: int = 1024, q_offset=0, kv_len=None) -> torch.Tensor:
    """Online-softmax attention over KV chunks of ``chunk``: live memory is
    O(Sq * chunk) per head. Scores and the weighted sum of V are taken in
    bfloat16, the running max, sum and accumulator in float32."""
    B, Sq, H, hd = q.shape
    Skv = k.shape[1]
    group = H // k.shape[2]
    scale = hd**-0.5
    qpos = q_offset + torch.arange(Sq, device=q.device)
    qf = q.to(torch.bfloat16)
    limit = Skv if kv_len is None else kv_len
    m = torch.full((B, H, Sq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, H, Sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, H, Sq, hd), dtype=torch.float32, device=q.device)
    pad = (-Skv) % chunk
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
    for start in range(0, k.shape[1], chunk):
        k_c = _expand_kv(k[:, start:start + chunk], group).to(torch.bfloat16)
        v_c = _expand_kv(v[:, start:start + chunk], group).to(torch.bfloat16)
        s = torch.einsum("bqhd,bkhd->bhqk", qf, k_c).float() * scale
        kpos = start + torch.arange(chunk, device=q.device)
        s = s + _mask_bias(qpos, kpos, causal=causal, window=window, kv_len=limit)
        m_new = torch.maximum(m, s.amax(dim=-1))
        corr = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * corr + p.sum(dim=-1)
        pv = torch.einsum("bhqk,bkhd->bhqd", p.to(torch.bfloat16), v_c)
        acc = acc * corr[..., None] + pv.float()
        m = m_new
    out = acc / l.clamp_min(1e-20)[..., None]
    return out.transpose(1, 2).to(q.dtype)


@spanned("model.attention")
def attention(q, k, v, *, impl: str = "xla_chunked", causal: bool = True,
              window: Optional[int] = None, chunk: int = 1024, q_offset=0, kv_len=None):
    if impl == "xla_dense":
        return attention_dense(q, k, v, causal=causal, window=window, q_offset=q_offset,
                               kv_len=kv_len)
    if impl == "xla_chunked":
        return attention_chunked(q, k, v, causal=causal, window=window, chunk=chunk,
                                 q_offset=q_offset, kv_len=kv_len)
    if impl == "pallas":
        return flash_attention(q, k, v, causal=causal, window=window)
    raise ValueError(f"unknown attention impl {impl!r}")


def decode_attention_local(q, k_cache, v_cache, cache_len, *,
                           window: Optional[int] = None) -> torch.Tensor:
    """One new token per row, q (B, 1, H, hd), against a local KV cache
    (B, S, KH, hd) of which the first ``cache_len`` entries (an int or a (B,)
    tensor) are valid.

    The query heads that share a KV head are taken side by side, so the
    cache is read as it lies instead of repeated per query head; and an int
    ``cache_len`` never becomes a device tensor, whose copy from the host
    would wait for the device once per layer."""
    B, _, H, hd = q.shape
    S, KH = k_cache.shape[1], k_cache.shape[2]
    qg = q.reshape(B, KH, H // KH, hd)  # head h = kh * group + j reads KV head kh
    s = torch.einsum("bkgd,bskd->bkgs", qg, k_cache).float() * hd**-0.5
    kpos = torch.arange(S, device=q.device)
    n = cache_len.to(q.device).reshape(-1, 1) if torch.is_tensor(cache_len) else cache_len
    valid = kpos[None, :] < n
    if window is not None:
        valid &= kpos[None, :] >= n - window
    s = s.masked_fill(~valid[:, None, None, :], NEG_INF)
    w = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.einsum("bkgs,bskd->bkgd", w, v_cache).reshape(B, 1, H, hd)


# ---------------------------------------------------------------------------
# The decode-attention slot (the KV-partition chunnel's seam)
# ---------------------------------------------------------------------------


class LocalDecode:
    """The decode slot's default: a cache that lies whole on this rank.

    A slot is called as ``attn_fn(q, k_cache, v_cache, kv_len, window)``, the
    reference's signature, and says two more things a partitioned cache
    changes (``comm.kvshard``): ``capacity(k_cache)``, the positions the
    cache holds over all its shards, and ``write(cache, new, pos)``, which
    puts the new entry ``new`` (B, 1, KH, hd) of position ``pos`` into this
    rank's ``cache`` (B, S, KH, hd) in place. In the reference the write is
    a ``dynamic_update_slice`` of the global array and the partitioner finds
    the owner."""

    def capacity(self, k_cache: torch.Tensor) -> int:
        return k_cache.shape[1]

    def write(self, cache: torch.Tensor, new: torch.Tensor, pos: int) -> None:
        cache[:, pos] = new[:, 0].to(cache.dtype)

    def __call__(self, q, k_cache, v_cache, kv_len, window=None):
        return decode_attention_local(q, k_cache, v_cache, kv_len, window=window)


class _FnDecode(LocalDecode):
    """A plain ``attn_fn`` over a whole local cache, in the slot."""

    def __init__(self, fn):
        self.fn = fn

    def __call__(self, q, k_cache, v_cache, kv_len, window=None):
        return self.fn(q, k_cache, v_cache, kv_len, window)


LOCAL_DECODE = LocalDecode()


def decode_slot(attn_fn=None) -> LocalDecode:
    """The slot for ``attn_fn``: the local default for None, a partitioned
    slot as it is (it has ``write``), a plain function over a whole cache
    wrapped."""
    if attn_fn is None:
        return LOCAL_DECODE
    return attn_fn if hasattr(attn_fn, "write") else _FnDecode(attn_fn)
