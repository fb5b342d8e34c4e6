"""One chunk of the SSM scan for Hopper, beside its plain PyTorch version.

``ssm_scan_chunk`` replaces the TPU kernel ``_scan_kernel``
(``src/repro/kernels/ssm_scan/ssm_scan.py``, via ``ssm_scan_chunk`` and the
wrapper in ``ops.py``). The kernel is CUDA C++ in ``csrc/ssm_scan.cu``, whose
head note says what it computes, what bounds it and how it is laid out.

It computes ``h_t = a_t * h_{t-1} + bx_t`` over the chunk's C steps, for
a, bx ``(B, C, d_in, N)`` float32 and h0 ``(B, d_in, N)``, and returns
``(h_seq (B, C, d_in, N), h_last (B, d_in, N))``. Chunks compose: ``h_last``
is the next chunk's ``h0``.

The wrapper runs the kernel on CUDA tensors and ``ssm_scan_chunk_ref`` on
CPU tensors, and raises on anything else and on a dtype other than float32.
On the card, a and bx may be views with any batch stride as long as each
row's ``(C, d_in, N)`` is contiguous (a chunk sliced out of a longer
sequence). ``launches`` on the wrapper counts kernel launches.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch import backend

_ARGTYPES = ([ctypes.c_void_p, ctypes.c_longlong] * 2 + [ctypes.c_void_p] * 3
             + [ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p])


def _lib() -> ctypes.CDLL:
    lib = backend.load_kernel_library("ssm_scan")
    lib.repro_ssm_scan_chunk.argtypes = _ARGTYPES
    lib.repro_ssm_scan_chunk.restype = ctypes.c_int
    return lib


def ssm_scan_chunk_ref(a: torch.Tensor, bx: torch.Tensor,
                       h0: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function in plain PyTorch: a float32 loop over t, the
    product and the sum rounded one at a time (what the TPU kernel's
    ``fori_loop`` computes). Elementwise only: on meta tensors
    (``launch.dryrun``'s FLOP count) it returns the shapes without the loop."""
    a, bx, h = a.float(), bx.float(), h0.float()
    h_seq = torch.empty_like(a)
    if a.device.type == "meta":
        return h_seq, h
    for t in range(a.shape[1]):
        h = a[:, t] * h + bx[:, t]
        h_seq[:, t] = h
    return h_seq, h


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise ValueError(what)


def ssm_scan_chunk(a: torch.Tensor, bx: torch.Tensor,
                   h0: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One chunk of ``h_t = a_t h_{t-1} + bx_t``: a, bx ``(B, C, d_in, N)``,
    h0 ``(B, d_in, N)``, all float32 -> ``(h_seq, h_last)``."""
    _check(a.dim() == 4 and a.shape == bx.shape,
           f"ssm_scan_chunk takes a and bx (B, C, d_in, N) alike, not {tuple(a.shape)} "
           f"and {tuple(bx.shape)}")
    B, C, d_in, N = a.shape
    _check(tuple(h0.shape) == (B, d_in, N), f"h0 {tuple(h0.shape)} does not fit a {tuple(a.shape)}")
    _check(min(B, C, d_in, N) > 0, f"ssm_scan_chunk needs nonempty shapes, not {tuple(a.shape)}")
    _check(a.dtype == bx.dtype == h0.dtype == torch.float32,
           f"ssm_scan_chunk takes float32, not {a.dtype}/{bx.dtype}/{h0.dtype}")
    _check(a.device == bx.device == h0.device, "a, bx and h0 must lie on one device")
    if a.device.type == "cpu":
        return ssm_scan_chunk_ref(a, bx, h0)
    _check(a.device.type == "cuda", f"ssm_scan_chunk takes CPU or CUDA tensors, not {a.device}")
    inner = (d_in * N, N, 1)
    _check(a.stride()[1:] == inner and bx.stride()[1:] == inner and h0.is_contiguous(),
           "ssm_scan_chunk needs each row's (C, d_in, N) of a and bx contiguous and h0 contiguous")
    h_seq = torch.empty((B, C, d_in, N), dtype=torch.float32, device=a.device)
    h_last = torch.empty((B, d_in, N), dtype=torch.float32, device=a.device)
    with torch.cuda.device(a.device):
        err = _lib().repro_ssm_scan_chunk(
            a.data_ptr(), a.stride(0), bx.data_ptr(), bx.stride(0), h0.data_ptr(),
            h_seq.data_ptr(), h_last.data_ptr(), B, C, d_in * N,
            torch.cuda.current_stream().cuda_stream)
    backend.check_launch("ssm_scan_chunk", err)
    ssm_scan_chunk.launches += 1
    return h_seq, h_last


ssm_scan_chunk.launches = 0
