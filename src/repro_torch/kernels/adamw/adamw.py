"""AdamW for Hopper in two hand-written passes a leaf, beside the plain
version in ``optim/adamw.py``.

Not a TPU kernel: the reference leaves AdamW to XLA. The plain version is
``optim/adamw.py``'s ``global_norm`` and ``clip_by_global_norm`` (the norm
and the clip) and ``_leaf_update`` (moments, step and decay of one leaf),
some 27 PyTorch kernels a leaf. ``update`` there sends every leaf of a tree
on the card here and every leaf of a tree on the CPU there, and counts the
routes in :data:`route_leaves`.

- :func:`sumsq` writes one leaf's float32 sum of squares into its slot of a
  device buffer (one launch; a double sum inside, so it may differ from
  ``torch.sum`` in the last bits).
- :func:`norm_scale` sums the slots in order and writes the global norm and
  the clip's scale to the device (one launch, no host synchronisation).
- :func:`adamw_step` clips, updates the moments, steps and decays one leaf in
  place, reading the scale from the device: bit-equal to ``g.mul_(scale)``
  followed by ``_leaf_update`` (one launch).

The kernels are CUDA C++ in ``csrc/adamw.cu``, whose head note says what
bounds them and how each rounding of the plain version is kept. They take a
tensor at any alignment as rows of contiguous elements a fixed stride apart
(:func:`rows`): a contiguous tensor, or a ZeRO-1 block narrowed on any dim.
The wrappers take CUDA tensors only and raise on anything else. Each
counts its launches in its ``launches`` attribute.
"""
from __future__ import annotations

import ctypes
from collections import Counter
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch import backend

#: leaves ``optim.adamw.update`` sent to the kernels ("kernel") and to
#: ``_leaf_update`` ("plain")
route_leaves: Counter = Counter()
#: sumsq's largest grid (8 blocks of 256 threads on each of 132 SMs) and so
#: its workspace: this many double partials, then the ticket
WORK_BLOCKS = 1056

_ARGTYPES = {
    "repro_sumsq": [ctypes.c_void_p] + [ctypes.c_longlong] * 3
                   + [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p],
    "repro_norm_scale": [ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_void_p,
                         ctypes.c_void_p],
    "repro_adamw_step": ([ctypes.c_void_p] * 5 + [ctypes.c_longlong] * 6
                         + [ctypes.c_float] * 9 + [ctypes.c_void_p]),
}
_ENTRIES: dict = {}
_WORK: dict = {}  # device -> sumsq's workspace


def _entry(name: str):
    """The library's entry point ``name``, its signature set once."""
    fn = _ENTRIES.get(name)
    if fn is None:
        fn = getattr(backend.load_kernel_library("adamw"), name)
        fn.argtypes, fn.restype = _ARGTYPES[name], ctypes.c_int
        _ENTRIES[name] = fn
    return fn


def _launch(wrapper, entry: str, device: torch.device, *args) -> None:
    """The library's ``entry(*args, stream)`` on ``device``'s current stream
    (``device`` made current for it), its error checked and counted in
    ``wrapper.launches``."""
    fn = _entry(entry)
    if device.index == torch.cuda.current_device():
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
    else:
        with torch.cuda.device(device):
            err = fn(*args, torch.cuda.current_stream().cuda_stream)
    backend.check_launch(wrapper.__name__, err)
    wrapper.launches += 1


def _on_card(what: str, *tensors: torch.Tensor) -> None:
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"{what} takes CUDA tensors, not {dev}")
    if any(t.device != dev for t in tensors):
        raise ValueError(f"{what} takes tensors on one device")


def rows(t: torch.Tensor) -> Optional[Tuple[int, int, int]]:
    """``(rows, cols, ld)``: ``t``'s elements in order as ``rows`` rows of
    ``cols`` contiguous elements, each row ``ld`` elements after the one
    before (one row when ``t`` is contiguous); None when they do not lie so
    (a transpose, rows that overlap)."""
    n = t.numel()
    if n == 0:
        return 0, 0, 0
    if t.is_contiguous():
        return 1, n, n
    dims = [(size, st) for size, st in zip(t.shape, t.stride()) if size != 1]
    cols = 1
    while dims and dims[-1][1] == cols:
        cols *= dims.pop()[0]
    if not dims:
        return 1, cols, cols
    ld = want = dims[-1][1]
    n = 1
    for size, st in reversed(dims):
        if st != want:
            return None
        n, want = n * size, want * size
    return (n, cols, ld) if ld >= cols else None


def _workspace(device: torch.device) -> torch.Tensor:
    """sumsq's scratch on ``device``, zeroed once: the launches on one
    stream share it, each leaving it ready for the next."""
    work = _WORK.get(device)
    if work is None:
        work = _WORK[device] = torch.zeros(WORK_BLOCKS + 1, dtype=torch.float64, device=device)
    return work


def sumsq(g: torch.Tensor, out: torch.Tensor) -> None:
    """The sum of squares of float32 ``g`` (laid out as :func:`rows` takes
    it) into ``out``, a one-element float32 view (a leaf's slot), on the
    current stream."""
    if not g.dtype == out.dtype == torch.float32:
        raise ValueError(f"sumsq takes float32 g and out, not {g.dtype} and {out.dtype}")
    _on_card("sumsq", g, out)
    lay = rows(g)
    if lay is None or out.numel() != 1:
        raise ValueError("sumsq takes g as rows of one stride and one slot, not strides "
                         f"{g.stride()} and {out.numel()} slots")
    _launch(sumsq, "repro_sumsq", g.device, g.data_ptr(), *lay,
            _workspace(g.device).data_ptr(), WORK_BLOCKS, out.data_ptr())


sumsq.launches = 0


def norm_scale(parts: torch.Tensor, max_norm: float) -> torch.Tensor:
    """``[norm, scale]`` float32 on the device: the square root of the sum of
    ``parts`` (1-d float32) taken in order, and the clip's scale
    ``min(max_norm / max(norm, 1e-12), 1)`` as ``clip_by_global_norm``
    computes it (left unwritten when ``max_norm`` is not above 0)."""
    if parts.dtype != torch.float32 or parts.dim() != 1:
        raise ValueError(f"norm_scale takes 1-d float32 parts, not {parts.dtype} "
                         f"{tuple(parts.shape)}")
    _on_card("norm_scale", parts)
    parts = parts.contiguous()
    out = torch.empty(2, dtype=torch.float32, device=parts.device)
    _launch(norm_scale, "repro_norm_scale", parts.device, parts.data_ptr(), parts.numel(),
            max_norm, out.data_ptr())
    return out


norm_scale.launches = 0


def _layout(ts) -> Tuple[int, int, list]:
    """``(rows, cols, [ld of each tensor])`` that lays out all of ``ts`` (one
    size) alike: the rows of those that are not contiguous, which must
    agree; a contiguous tensor takes any rows."""
    lays = [rows(t) for t in ts]
    if None in lays:
        raise ValueError("adamw_step takes tensors laid out as rows of one stride, not strides "
                         f"{[t.stride() for t in ts]}")
    wide = {lay[:2] for lay in lays if lay[0] > 1}
    if not wide:
        n = ts[0].numel()
        return 1, n, [n] * len(ts)
    if len(wide) > 1 or len({t.shape for t in ts}) > 1:
        raise ValueError(f"adamw_step takes tensors of one layout, not {lays}")
    n_rows, cols = wide.pop()
    return n_rows, cols, [lay[2] if lay[0] > 1 else cols for lay in lays]


def adamw_step(pv: torch.Tensor, g: torch.Tensor, m: torch.Tensor, v: torch.Tensor,
               scale, *, lr: float, c1: float, c2: float, beta1: float, beta2: float,
               eps: float, weight_decay: float) -> None:
    """One leaf's AdamW step in place: ``g * scale`` (``scale`` a one-element
    float32 CUDA tensor, or None for no clip), then ``_leaf_update``'s
    moments, step and decay with bias corrections ``c1``, ``c2``. ``pv`` and
    ``g`` float32, ``m`` and ``v`` bfloat16, all of one size on one CUDA
    device, each laid out as :func:`rows` takes it."""
    if not (pv.dtype == g.dtype == torch.float32 and m.dtype == v.dtype == torch.bfloat16):
        raise ValueError("adamw_step takes float32 p and g and bfloat16 m and v, not "
                         f"{pv.dtype}, {g.dtype}, {m.dtype}, {v.dtype}")
    if scale is None:
        _on_card("adamw_step", pv, g, m, v)
    else:
        _on_card("adamw_step", pv, g, m, v, scale)
        if scale.dtype != torch.float32 or scale.numel() != 1:
            raise ValueError("adamw_step takes a one-element float32 scale")
    if not pv.numel() == g.numel() == m.numel() == v.numel():
        raise ValueError("adamw_step takes tensors of one size, not "
                         f"{[tuple(t.shape) for t in (pv, g, m, v)]}")
    n_rows, cols, lds = _layout((pv, g, m, v))
    inv_c1 = float(np.float32(1.0) / np.float32(c1))  # PyTorch's `t / c`: t * f32(1/c)
    inv_c2 = float(np.float32(1.0) / np.float32(c2))
    _launch(adamw_step, "repro_adamw_step", pv.device, pv.data_ptr(), g.data_ptr(),
            m.data_ptr(), v.data_ptr(), None if scale is None else scale.data_ptr(), n_rows,
            cols, *lds, beta1, 1 - beta1, beta2, 1 - beta2, inv_c1, inv_c2, eps, lr,
            weight_decay)


adamw_step.launches = 0
