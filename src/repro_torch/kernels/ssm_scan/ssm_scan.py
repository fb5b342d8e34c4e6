"""The SSM scan for Hopper, beside its plain PyTorch versions: two kernels.

``selective_scan`` is B4 redesigned for this card: one layer's whole
selective scan in one launch. For dt, x ``(B, S, d_in)``, B and C ``(B, S,
N)``, A ``(d_in, N)`` (already ``-exp(A_log)``), h0 ``(B, d_in, N)`` and D
``(d_in,)`` it computes ``a = exp(dt A)``, ``h_t = a_t h_{t-1} + dt_t x_t
B_t``, ``y_t = C_t . h_t + D x_t`` and returns ``(y (B, S, d_in),
h_last (B, d_in, N))``, both float32, reading only those inputs and writing
only those outputs. It is what ``models/ssm.py``'s ``ssm_apply`` runs under
``impl="pallas"``, prefill and decode; ``selective_scan_ref`` is its plain
version, the route of ``impl="jnp"`` and of training.

``ssm_scan_chunk`` is the literal counterpart of the TPU kernel
``_scan_kernel`` (``src/repro/kernels/ssm_scan/ssm_scan.py``, via
``ssm_scan_chunk`` and the wrapper in ``ops.py``): ``h_t = a_t * h_{t-1} +
bx_t`` over one chunk of C steps, for a, bx ``(B, C, d_in, N)`` float32 and
h0 ``(B, d_in, N)``, returning ``(h_seq (B, C, d_in, N), h_last (B, d_in,
N))``. Chunks compose: ``h_last`` is the next chunk's ``h0``. No serving path
launches it since ``selective_scan`` took its place.

Both kernels are CUDA C++ in ``csrc/ssm_scan.cu``, whose notes say what they
compute, what bounds them and how they are laid out. Each wrapper runs its
kernel on CUDA tensors and its plain version on CPU tensors, raises on
anything else and on inputs its kernel does not take, and counts kernel
launches in ``launches``. ``selective_scan`` reads every input through its
strides; ``ssm_scan_chunk`` takes a and bx views with any batch stride as
long as each row's ``(C, d_in, N)`` is contiguous (a chunk sliced out of a
longer sequence).
"""
from __future__ import annotations

import ctypes
import struct
from typing import Tuple

import torch

from repro_torch import backend

_CHUNK_ARGTYPES = ([ctypes.c_void_p, ctypes.c_longlong] * 2 + [ctypes.c_void_p] * 3
                   + [ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p])
_SCAN_ARGTYPES = [ctypes.c_char_p, ctypes.c_int, ctypes.c_void_p]
_ENTRIES: dict = {}

#: the fused kernel's state widths (compiled in)
STATES = (4, 8, 16)


def _entry(name: str, argtypes: list):
    """The library's entry point ``name``, its signature set once."""
    fn = _ENTRIES.get(name)
    if fn is None:
        fn = getattr(backend.load_kernel_library("ssm_scan"), name)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        _ENTRIES[name] = fn
    return fn


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


def ssm_scan_chunk(a: torch.Tensor, bx: torch.Tensor,
                   h0: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One chunk of ``h_t = a_t h_{t-1} + bx_t``: a, bx ``(B, C, d_in, N)``,
    h0 ``(B, d_in, N)``, all float32 -> ``(h_seq, h_last)``."""
    if a.dim() != 4 or a.shape != bx.shape:
        raise ValueError(f"ssm_scan_chunk takes a and bx (B, C, d_in, N) alike, not "
                         f"{tuple(a.shape)} and {tuple(bx.shape)}")
    B, C, d_in, N = a.shape
    if tuple(h0.shape) != (B, d_in, N):
        raise ValueError(f"h0 {tuple(h0.shape)} does not fit a {tuple(a.shape)}")
    if min(B, C, d_in, N) <= 0:
        raise ValueError(f"ssm_scan_chunk needs nonempty shapes, not {tuple(a.shape)}")
    if not a.dtype == bx.dtype == h0.dtype == torch.float32:
        raise ValueError(f"ssm_scan_chunk takes float32, not {a.dtype}/{bx.dtype}/{h0.dtype}")
    if not a.device == bx.device == h0.device:
        raise ValueError("a, bx and h0 must lie on one device")
    if a.device.type == "cpu":
        return ssm_scan_chunk_ref(a, bx, h0)
    if a.device.type != "cuda":
        raise ValueError(f"ssm_scan_chunk takes CPU or CUDA tensors, not {a.device}")
    inner = (d_in * N, N, 1)
    if a.stride()[1:] != inner or bx.stride()[1:] != inner or not h0.is_contiguous():
        raise ValueError("ssm_scan_chunk needs each row's (C, d_in, N) of a and bx "
                         "contiguous and h0 contiguous")
    h_seq = torch.empty((B, C, d_in, N), dtype=torch.float32, device=a.device)
    h_last = torch.empty((B, d_in, N), dtype=torch.float32, device=a.device)
    with torch.cuda.device(a.device):
        err = _entry("repro_ssm_scan_chunk", _CHUNK_ARGTYPES)(
            a.data_ptr(), a.stride(0), bx.data_ptr(), bx.stride(0), h0.data_ptr(),
            h_seq.data_ptr(), h_last.data_ptr(), B, C, d_in * N,
            torch.cuda.current_stream().cuda_stream)
    backend.check_launch("ssm_scan_chunk", err)
    ssm_scan_chunk.launches += 1
    return h_seq, h_last


ssm_scan_chunk.launches = 0


def selective_scan_ref(dt: torch.Tensor, x: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor,
                       A: torch.Tensor, h0: torch.Tensor, D: torch.Tensor,
                       chunk: int = 256) -> Tuple[torch.Tensor, torch.Tensor]:
    """The fused kernel's function in plain PyTorch, in its rounding order:
    a = exp(dt A) and bx = (dt x) B materialised ``chunk`` steps at a time,
    scanned by ``ssm_scan_chunk_ref``, contracted with C in n order (each
    product and sum rounded by itself), then ``+ D x``. The chunk length
    moves no rounding, only the memory the chunk's (B, chunk, d_in, N)
    tensors take. Differentiable (the training route). On meta tensors
    (``launch.dryrun``'s FLOP count; all of it elementwise) it returns the
    shapes without the loop."""
    Bsz, S, d_in = dt.shape
    N = A.shape[-1]
    h = h0.float()
    if dt.device.type == "meta":
        y = dt.new_empty((Bsz, S, d_in), dtype=torch.float32)
    else:
        ys = []
        for start in range(0, S, chunk):
            dtc = dt[:, start:start + chunk].float()
            a = (dtc[..., None] * A).exp_()
            bx = (dtc * x[:, start:start + chunk].float())[..., None] \
                * Bm[:, start:start + chunk].float()[..., None, :]
            h_seq, h = ssm_scan_chunk_ref(a, bx, h)
            # unbound, not sliced: a slice's backward fills a whole h_seq
            # of zeros for each n, unbind's stacks the N gradients once
            hn, cn = h_seq.unbind(-1), Cm[:, start:start + chunk].float().unbind(-1)
            yc = hn[0] * cn[0][..., None]
            for n in range(1, N):
                yc = yc + hn[n] * cn[n][..., None]
            ys.append(yc)
        y = torch.cat(ys, dim=1) if len(ys) > 1 else ys[0]
    return y + D * x.float(), h


def selective_scan(dt: torch.Tensor, x: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor,
                   A: torch.Tensor, h0: torch.Tensor, D: torch.Tensor,
                   chunk: int = 256) -> Tuple[torch.Tensor, torch.Tensor]:
    """One SSM layer's selective scan: dt float32 and x bfloat16 ``(B, S,
    d_in)``, Bm and Cm ``(B, S, N)`` bfloat16 or float32, A ``(d_in, N)``, h0
    ``(B, d_in, N)`` and D ``(d_in,)`` float32 -> ``(y, h_last)``.
    ``chunk`` is the plain version's, on CPU tensors; the kernel has none."""
    if dt.dim() != 3 or x.shape != dt.shape:
        raise ValueError(f"selective_scan takes dt and x (B, S, d_in) alike, not "
                         f"{tuple(dt.shape)} and {tuple(x.shape)}")
    Bsz, S, d_in = dt.shape
    N = A.shape[-1]
    if (tuple(A.shape) != (d_in, N) or tuple(Bm.shape) != (Bsz, S, N)
            or Cm.shape != Bm.shape or tuple(h0.shape) != (Bsz, d_in, N)
            or tuple(D.shape) != (d_in,)):
        raise ValueError(f"selective_scan: B {tuple(Bm.shape)}, C {tuple(Cm.shape)}, A "
                         f"{tuple(A.shape)}, h0 {tuple(h0.shape)}, D {tuple(D.shape)} do not "
                         f"fit dt {tuple(dt.shape)}")
    if min(Bsz, S, d_in, N) <= 0:
        raise ValueError(f"selective_scan needs nonempty shapes, not {tuple(dt.shape)} x {N}")
    if (any(t.dtype != torch.float32 for t in (dt, A, h0, D)) or x.dtype != torch.bfloat16
            or Bm.dtype != Cm.dtype or Bm.dtype not in (torch.bfloat16, torch.float32)):
        raise ValueError(f"selective_scan takes dt, A, h0, D float32, x bfloat16 and B, C "
                         f"alike in bfloat16 or float32, not dt {dt.dtype}, x {x.dtype}, B "
                         f"{Bm.dtype}, C {Cm.dtype}, A {A.dtype}, h0 {h0.dtype}, D {D.dtype}")
    dev = dt.device
    if any(t.device != dev for t in (x, Bm, Cm, A, h0, D)):
        raise ValueError("selective_scan's inputs must lie on one device")
    if dev.type == "cpu":
        return selective_scan_ref(dt, x, Bm, Cm, A, h0, D, chunk)
    if dev.type != "cuda":
        raise ValueError(f"selective_scan takes CPU or CUDA tensors, not {dev}")
    if N not in STATES or Bsz > 65535:
        raise ValueError(f"selective_scan's kernel takes N in {STATES} and B up to 65535, "
                         f"not N {N}, B {Bsz}")
    y = torch.empty((Bsz, S, d_in), dtype=torch.float32, device=dev)
    h_last = torch.empty((Bsz, d_in, N), dtype=torch.float32, device=dev)
    # ScanArgs of csrc/ssm_scan.cu: pointers, strides in elements and sizes,
    # 31 int64 (packed in one call: a ctypes.Structure costs twice the time)
    args = struct.pack("31q", dt.data_ptr(), *dt.stride(), x.data_ptr(), *x.stride(),
                       Bm.data_ptr(), *Bm.stride(), Cm.data_ptr(), *Cm.stride(), A.data_ptr(),
                       *A.stride(), h0.data_ptr(), *h0.stride(), D.data_ptr(), D.stride(0),
                       y.data_ptr(), h_last.data_ptr(), Bsz, S, d_in, N)
    with torch.cuda.device(dev):
        err = _entry("repro_selective_scan", _SCAN_ARGTYPES)(
            args, Bm.dtype == torch.bfloat16, torch.cuda.current_stream().cuda_stream)
    backend.check_launch("selective_scan", err)
    selective_scan.launches += 1
    return y, h_last


selective_scan.launches = 0
