"""Gradient wire formats: int8 block quantization.

The 'serialization chunnel' analogue (exact-match capability: every peer must
speak the same wire format). Both directions run through the packed kernels
of ``repro_torch.kernels.quantize`` (``quantize_pack`` out,
``unpack_dequant_sum`` back) — on a CUDA tensor the Hopper kernel, on a CPU
tensor its plain PyTorch version — so the arithmetic is defined once.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels.quantize.quantize import quantize_pack, unpack_dequant_sum


def int8_wire_ratio(block: int = 256) -> float:
    """Wire bytes per f32 payload byte of the int8 block format: one int8 per
    4-byte float plus one f32 scale per block — the ``dcn_bytes_per_byte``
    cost-model term of every chunnel speaking this format."""
    return (1.0 + 4.0 / block) / 4.0


def quantize_int8(x: torch.Tensor, *, block: int = 256) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (any shape) -> (q int8 (nblocks, block), scales fp32 (nblocks,))."""
    flat = x.reshape(-1).to(torch.float32)
    flat = torch.nn.functional.pad(flat, (0, (-flat.numel()) % block))
    n_blocks = flat.numel() // block
    packed = quantize_pack(flat.view(n_blocks, block))
    n = n_blocks * block
    return (packed[:n].view(torch.int8).view(n_blocks, block),
            packed[n:].clone().view(torch.float32))


def dequantize_sum_int8(q: torch.Tensor, scales: torch.Tensor, shape) -> torch.Tensor:
    """n ranks' codes (n, n_blocks, block) and scales (n, n_blocks), each
    rank's dequantized and the n summed in rank order, in one launch, as
    ``shape``: the body of the compressed all-gather-sum."""
    n = 1
    for s in shape:
        n *= s
    return unpack_dequant_sum(q, scales)[:n].view(shape)


def dequantize_int8(q: torch.Tensor, scales: torch.Tensor, shape, *,
                    block: int = 256) -> torch.Tensor:
    """The codes and scales read where they lie: the sum over one rank."""
    return dequantize_sum_int8(q.reshape(1, -1, block), scales.reshape(1, -1), shape)


def quantize_error(x: torch.Tensor, *, block: int = 256) -> torch.Tensor:
    """Residual x - dq(q(x)) for error feedback."""
    q, s = quantize_int8(x, block=block)
    return x - dequantize_int8(q, s, x.shape, block=block)
