"""Operations and bytes of one call of a kernel's op, derived from PERF.md's
kernel-bound rule (every input read once, every output written once, the
operations at the peak of their type) and its counts for B3 and B4. Bytes use
the configuration's declared dtypes (``dtypes`` in its file), never the
runtime tensors', so a kernel that changes its operands' types cannot make
the count stale.
"""
from __future__ import annotations

from typing import Optional

from portbench.counts.peaks import HBM_BYTES_PER_S, PEAK_FLOPS

BYTES = {"float32": 4, "bfloat16": 2, "float16": 2, "float8": 1, "int8": 1}


def least_seconds(ops: float, nbytes: float, op_dtype: str) -> float:
    """The least time the chip could take: the larger of the operations at
    their type's peak and the bytes at HBM bandwidth."""
    return max(ops / PEAK_FLOPS[op_dtype], nbytes / HBM_BYTES_PER_S)


def attention_pairs(sq: int, skv: int, causal: bool, window: Optional[int],
                    prefix: int = 0) -> int:
    """The (query, key) pairs that the masks leave, for a prompt whose
    queries are its keys (sq == skv) or for unmasked attention. ``prefix``:
    keys k < prefix are seen by every query at or after them, window or not
    (``reference.common.attention``)."""
    if not causal:
        if window is not None or prefix:
            raise ValueError("a window or a prefix without causality is not counted")
        return sq * skv
    if sq != skv:
        raise ValueError(f"causal attention is counted for sq == skv, not {sq}, {skv}")
    w = skv if window is None else min(window, skv)
    # query p sees min(p + 1, w) keys
    pairs = w * (w + 1) // 2 + (sq - w) * w
    # and the j = p - w + 1 prefix keys left of its window, at most ``prefix``
    n, P = sq - w + 1, min(prefix, sq)
    if window is None or n <= 0 or not P:
        return pairs
    return pairs + (n * (n - 1) // 2 if n <= P else P * (P - 1) // 2 + P * (n - P))


def flash_attention(q_shape, kv_shape, causal: bool, window: Optional[int],
                    dtypes: dict, prefix: int = 0) -> tuple:
    """(ops, bytes, op dtype) of attention over q (B, Sq, H, hd) and k, v
    (B, Skv, KH, hd): QK^T and PV over the unmasked pairs (a ``prefix`` as
    ``attention_pairs`` has it); q, k, v read and o written once in the
    compute dtype."""
    B, Sq, H, hd = q_shape
    _, Skv, KH, _ = kv_shape
    ops = 4.0 * B * H * hd * attention_pairs(Sq, Skv, causal, window, prefix)
    nbytes = (2 * B * Sq * H * hd + 2 * B * Skv * KH * hd) * BYTES[dtypes["compute"]]
    return ops, float(nbytes), dtypes["compute"]


def selective_scan(B: int, S: int, d_in: int, N: int, dtypes: dict) -> tuple:
    """(ops, bytes, op dtype) of one layer's selective scan: dt, x, B, C, A, D
    and h0 read once, y and h_last written once; 7 operations per (b, t, d,
    n) (dt A, exp, dt x B, the decay and the add, the product with C and its
    sum) and 2 per (b, t, d) (D x and its add), in the state's type."""
    st, comp, par = (BYTES[dtypes[k]] for k in ("ssm_state", "compute", "param"))
    nbytes = (B * S * d_in * BYTES[dtypes["ssm_dt"]]  # dt
              + B * S * d_in * comp  # x
              + 2 * B * S * N * comp  # B, C
              + d_in * N * par + d_in * par  # A, D
              + 2 * B * d_in * N * st  # h0, h_last
              + B * S * d_in * BYTES[dtypes["ssm_out"]])  # y
    ops = 7.0 * B * S * d_in * N + 2.0 * B * S * d_in
    return ops, float(nbytes), dtypes["ssm_state"]
