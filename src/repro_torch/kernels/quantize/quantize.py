"""Int8 block quantization fused with the wire's packing, for Hopper.

``quantize_pack`` replaces the TPU kernel ``_quant_kernel``
(``src/repro/kernels/quantize/quantize.py``, via ``quantize_blocks``) and the
pack of ``src/repro/comm/wire.py::_fused_encode``; ``unpack_dequant`` replaces
``_dequant_kernel`` (via ``dequantize_blocks``) and the unpack of
``_fused_decode``. The kernels are CUDA C++ in ``csrc/quantize.cu``, whose
head note says what bounds them and why the arithmetic is what it is.

Packed layout: ``n_blocks * block`` int8 codes, then ``n_blocks``
little-endian float32 scales, in one uint8 buffer — byte for byte the
reference's wire.

Each wrapper runs its kernel on a CUDA tensor and its plain PyTorch version
(``*_ref``, the same arithmetic) on a CPU tensor, and raises on anything
else. Each kernel has two routes, each its own C entry point: ``vector`` for
blocks that are powers of two from 4 to 1024 when every pointer starts at a
16-byte boundary, ``scalar`` for the rest (:func:`route`). ``launches`` on
each wrapper counts its kernel launches; ``route_launches`` counts them by
``(route, block)``.
"""
from __future__ import annotations

import ctypes
from collections import Counter

import numpy as np
import torch

from repro_torch import backend

#: f32(1/127): XLA turns the reference's ``amax / 127.0`` into
#: ``amax * f32(1/127)`` under jit, and the wire carries those scales
INV127 = float(np.float32(1.0) / np.float32(127.0))

_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
             ctypes.c_void_p]


#: the C entry point of each kernel and route
ENTRY = {("quantize_pack", "scalar"): "repro_quantize_pack",
         ("quantize_pack", "vector"): "repro_quantize_pack_vec",
         ("unpack_dequant", "scalar"): "repro_unpack_dequant",
         ("unpack_dequant", "vector"): "repro_unpack_dequant_vec"}
#: the blocks the vector route takes: powers of two from 4 to 1024
VECTOR_BLOCKS = frozenset(4 << k for k in range(9))


def _lib() -> ctypes.CDLL:
    lib = backend.load_kernel_library("quantize")
    for name in ENTRY.values():
        fn = getattr(lib, name)
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return lib


def route(block: int, *tensors: torch.Tensor) -> str:
    """``"vector"`` when ``block`` is a power of two from 4 to 1024 and every
    tensor starts at a 16-byte boundary, else ``"scalar"``: from the shape
    and the pointers alone, before any launch."""
    aligned = all(t.data_ptr() % 16 == 0 for t in tensors)
    return "vector" if block in VECTOR_BLOCKS and aligned else "scalar"


def launch(kernel: str, which: str, src: torch.Tensor, dst: torch.Tensor,
           n_blocks: int, block: int) -> None:
    """One launch of ``kernel`` by route ``which`` from ``src`` into ``dst``,
    on the current stream; counts nothing. The wrappers call it, and timing
    code may, to hold the two routes side by side."""
    with torch.cuda.device(src.device):
        err = getattr(_lib(), ENTRY[(kernel, which)])(
            src.data_ptr(), dst.data_ptr(), n_blocks, block,
            torch.cuda.current_stream().cuda_stream)
    backend.check_launch(f"{kernel} ({which} route)", err)


def packed_nbytes(n_blocks: int, block: int) -> int:
    return n_blocks * block + 4 * n_blocks


def quantize_pack_ref(x2d: torch.Tensor) -> torch.Tensor:
    """(n_blocks, block) f32 -> packed uint8, in plain PyTorch."""
    amax = x2d.abs().amax(dim=1)
    s = torch.where(amax > 0, amax * INV127, torch.ones_like(amax))
    q = torch.clamp(torch.round(x2d / s[:, None]), -127, 127).to(torch.int8)
    return torch.cat([q.reshape(-1).view(torch.uint8), s.view(torch.uint8)])


def unpack_dequant_ref(packed: torch.Tensor, n_blocks: int, block: int) -> torch.Tensor:
    """Packed uint8 -> flat f32 of ``n_blocks * block``, in plain PyTorch."""
    n = n_blocks * block
    q = packed[:n].view(torch.int8).view(n_blocks, block).to(torch.float32)
    s = packed[n:].clone().view(torch.float32)  # clone: byte n may be unaligned
    return (q * s[:, None]).reshape(-1)


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise ValueError(what)


def quantize_pack(x2d: torch.Tensor) -> torch.Tensor:
    """(n_blocks, block) contiguous f32 -> one uint8 buffer of
    ``n_blocks*block + 4*n_blocks`` bytes: codes, then scales."""
    _check(x2d.dtype == torch.float32, f"quantize_pack takes float32, not {x2d.dtype}")
    _check(x2d.dim() == 2 and x2d.shape[0] > 0 and x2d.shape[1] > 0,
           f"quantize_pack takes a nonempty (n_blocks, block), not {tuple(x2d.shape)}")
    _check(x2d.is_contiguous(), "quantize_pack takes a contiguous tensor")
    if x2d.device.type == "cpu":
        return quantize_pack_ref(x2d)
    _check(x2d.device.type == "cuda",
           f"quantize_pack takes CPU or CUDA tensors, not {x2d.device}")
    n_blocks, block = x2d.shape
    out = torch.empty(packed_nbytes(n_blocks, block), dtype=torch.uint8,
                      device=x2d.device)
    which = route(block, x2d, out)
    launch("quantize_pack", which, x2d, out, n_blocks, block)
    quantize_pack.launches += 1
    quantize_pack.route_launches[(which, block)] += 1
    return out


quantize_pack.launches = 0
quantize_pack.route_launches = Counter()


def unpack_dequant(packed: torch.Tensor, n_blocks: int, block: int) -> torch.Tensor:
    """Packed uint8 buffer -> flat f32 of ``n_blocks * block`` elements."""
    _check(packed.dtype == torch.uint8, f"unpack_dequant takes uint8, not {packed.dtype}")
    _check(n_blocks > 0 and block > 0, "unpack_dequant takes n_blocks, block > 0")
    _check(packed.dim() == 1 and packed.numel() == packed_nbytes(n_blocks, block),
           f"unpack_dequant takes a flat buffer of {packed_nbytes(n_blocks, block)} "
           f"bytes, not {tuple(packed.shape)}")
    _check(packed.is_contiguous(), "unpack_dequant takes a contiguous tensor")
    if packed.device.type == "cpu":
        return unpack_dequant_ref(packed, n_blocks, block)
    _check(packed.device.type == "cuda",
           f"unpack_dequant takes CPU or CUDA tensors, not {packed.device}")
    out = torch.empty(n_blocks * block, dtype=torch.float32, device=packed.device)
    which = route(block, packed, out)
    launch("unpack_dequant", which, packed, out, n_blocks, block)
    unpack_dequant.launches += 1
    unpack_dequant.route_launches[(which, block)] += 1
    return out


unpack_dequant.launches = 0
unpack_dequant.route_launches = Counter()
