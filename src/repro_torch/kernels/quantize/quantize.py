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

``unpack_dequant_sum`` is not a TPU kernel: it replaces the body of
``src/repro/comm/collectives.py::compressed_allgather_sum`` after the
all-gathers (a vmap of ``dequantize_int8``, which reaches ``_dequant_kernel``,
then ``jnp.sum``), summing the n ranks' dequantized codes in rank order in
one launch, and is also the error feedback's dequantize (n = 1).

Each wrapper runs its kernel on a CUDA tensor and its plain PyTorch version
(``*_ref``, the same arithmetic) on a CPU tensor, and raises on anything
else. Each kernel has two routes, each its own C entry point: ``vector`` for
blocks that are powers of two from 4 to 1024 when every pointer starts at a
16-byte boundary, ``scalar`` for the rest (:func:`route`). ``launches`` on
each wrapper counts its kernel launches; ``route_launches`` counts them by
``(route, block)`` and ``size_launches`` by the floats of one rank's flat
vector (``n_blocks * block``). The counts are bumped under one lock, because
a wire may encode in one thread while another decodes (``WanGateway``).
"""
from __future__ import annotations

import ctypes
import threading
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
         ("unpack_dequant", "vector"): "repro_unpack_dequant_vec",
         ("unpack_dequant_sum", "scalar"): "repro_unpack_dequant_sum",
         ("unpack_dequant_sum", "vector"): "repro_unpack_dequant_sum_vec"}
#: codes, scales, out, n_blocks, block, n, stream
_SUM_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                 ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
#: the blocks the vector route takes: powers of two from 4 to 1024
VECTOR_BLOCKS = frozenset(4 << k for k in range(9))


def _lib() -> ctypes.CDLL:
    lib = backend.load_kernel_library("quantize")
    for (kernel, _), name in ENTRY.items():
        fn = getattr(lib, name)
        fn.argtypes = _SUM_ARGTYPES if kernel == "unpack_dequant_sum" else _ARGTYPES
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


_COUNT_LOCK = threading.Lock()


def count_launch(wrapper, which: str, block: int, floats: int = 0) -> None:
    """One launch of ``wrapper``'s kernel by route ``which`` at ``block`` on
    ``floats`` floats a rank, added to ``wrapper.launches``,
    ``wrapper.route_launches`` and ``wrapper.size_launches`` under a lock,
    so that threads launching at once lose no count."""
    with _COUNT_LOCK:
        wrapper.launches += 1
        wrapper.route_launches[(which, block)] += 1
        wrapper.size_launches[floats] += 1


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
    count_launch(quantize_pack, which, block, n_blocks * block)
    return out


quantize_pack.launches = 0
quantize_pack.route_launches = Counter()
quantize_pack.size_launches = Counter()


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
    count_launch(unpack_dequant, which, block, n_blocks * block)
    return out


unpack_dequant.launches = 0
unpack_dequant.route_launches = Counter()
unpack_dequant.size_launches = Counter()


def unpack_dequant_sum_ref(codes: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """Codes (n, n_blocks, block) int8 and scales (n, n_blocks) f32 -> flat
    f32 of ``n_blocks * block``: the n dequantizes summed in rank order, in
    plain PyTorch."""
    acc = codes[0].to(torch.float32) * scales[0][:, None]
    for k in range(1, codes.shape[0]):
        acc = acc + codes[k].to(torch.float32) * scales[k][:, None]
    return acc.reshape(-1)


def launch_sum(which: str, codes: torch.Tensor, scales: torch.Tensor, out: torch.Tensor) -> None:
    """One launch of ``unpack_dequant_sum`` by route ``which``, on the
    current stream; counts nothing."""
    n, n_blocks, block = codes.shape
    with torch.cuda.device(codes.device):
        err = getattr(_lib(), ENTRY[("unpack_dequant_sum", which)])(
            codes.data_ptr(), scales.data_ptr(), out.data_ptr(), n_blocks, block, n,
            torch.cuda.current_stream().cuda_stream)
    backend.check_launch(f"unpack_dequant_sum ({which} route)", err)


def unpack_dequant_sum(codes: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """Codes (n, n_blocks, block) int8 and scales (n, n_blocks) float32, both
    contiguous on one device -> flat float32 of ``n_blocks * block``, the sum
    over the n ranks of each one's dequantized codes, in rank order."""
    _check(codes.dtype == torch.int8, f"unpack_dequant_sum takes int8 codes, not {codes.dtype}")
    _check(scales.dtype == torch.float32,
           f"unpack_dequant_sum takes float32 scales, not {scales.dtype}")
    _check(codes.dim() == 3 and codes.numel() > 0,
           f"unpack_dequant_sum takes nonempty codes (n, n_blocks, block), not "
           f"{tuple(codes.shape)}")
    _check(tuple(scales.shape) == tuple(codes.shape[:2]),
           f"scales {tuple(scales.shape)} for codes {tuple(codes.shape)}")
    _check(codes.is_contiguous() and scales.is_contiguous(),
           "unpack_dequant_sum takes contiguous tensors")
    _check(codes.device == scales.device,
           f"codes on {codes.device}, scales on {scales.device}")
    if codes.device.type == "cpu":
        return unpack_dequant_sum_ref(codes, scales)
    _check(codes.device.type == "cuda",
           f"unpack_dequant_sum takes CPU or CUDA tensors, not {codes.device}")
    n, n_blocks, block = codes.shape
    out = torch.empty(n_blocks * block, dtype=torch.float32, device=codes.device)
    which = route(block, codes, scales, out)
    launch_sum(which, codes, scales, out)
    count_launch(unpack_dequant_sum, which, block, n_blocks * block)
    return out


unpack_dequant_sum.launches = 0
unpack_dequant_sum.route_launches = Counter()
unpack_dequant_sum.size_launches = Counter()
