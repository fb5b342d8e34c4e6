"""Forward flash attention for Hopper, beside its plain PyTorch version.

``flash_attention`` replaces the TPU kernel ``_fa_kernel``
(``src/repro/kernels/flash_attention/flash_attention.py``, via
``flash_attention`` and the wrapper in ``ops.py``). The kernel is CUDA C++ in
``csrc/flash_attention.cu``, whose head note says what it computes, what
bounds it and how it is laid out. It has two routes, chosen by dtype:

- bfloat16 (what the served configs compute in): a Hopper kernel on the
  tensor cores (``wgmma``), fed by TMA loads through an mbarrier ring. The
  tensor cores take the softmax weights p in bf16 for the P.V product, so p
  is rounded there while the row sum l adds the float32 p; the result
  agrees with the plain float32 function within atol = rtol = 1e-2. TMA
  needs a 16-byte-aligned base and byte strides that are multiples of 16
  (``tma_strides``): the wrapper raises on anything else, and never copies
  or falls back.
- float32: a kernel on the float32 CUDA cores, within 2e-5 of the plain
  version (TF32 tensor cores could not meet that).

At llama3.2-1b's prefill shape the work is bound by operations (68,753,031,168
flops against 83,886,080 bytes of q, k, v and o).

Layouts are the reference's: q ``(B, Sq, H, hd)``, k and v ``(B, Skv, KH, hd)``
with ``H % KH == 0`` (GQA reads KV head ``h // (H // KH)``); the output is
``(B, Sq, H, hd)`` in q's dtype. The causal mask is top-left aligned (query
and key positions both start at 0), and a window keeps ``qpos - kpos < window``.

The wrapper runs the kernel on CUDA tensors and ``flash_attention_ref`` on
CPU tensors, and raises on anything else, on a dtype other than bfloat16 or
float32, on a head dim the kernel was not built for, and on bf16 tensors
that TMA cannot read. ``launches`` on the wrapper counts kernel launches,
and ``shape_launches`` counts them by (q shape, k shape, causal).
"""
from __future__ import annotations

import ctypes
from collections import Counter
from typing import Optional

import torch

from repro_torch import backend

NEG_INF = -1e30
#: head dims the kernel is instantiated for (the reference's test sweep,
#: llama3.2-1b's and seamless-m4t's 64, phi-3-vision's 96, mistral-nemo's
#: and qwen3-moe's 128)
HEAD_DIMS = (16, 32, 64, 96, 128)
DTYPES = (torch.bfloat16, torch.float32)

_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_longlong] * 9
             + [ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_float, ctypes.c_void_p])


def _lib() -> ctypes.CDLL:
    lib = backend.load_kernel_library("flash_attention")
    lib.repro_flash_attention.argtypes = _ARGTYPES
    lib.repro_flash_attention.restype = ctypes.c_int
    return lib


def _mask(sq: int, skv: int, causal: bool, window: Optional[int], device) -> torch.Tensor:
    """(Sq, Skv) bool of kept positions, top-left aligned."""
    qpos = torch.arange(sq, device=device)[:, None]
    kpos = torch.arange(skv, device=device)[None, :]
    ok = torch.ones(sq, skv, dtype=torch.bool, device=device)
    if causal:
        ok &= kpos <= qpos
    if window is not None:
        ok &= qpos - kpos < window
    return ok


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: Optional[int] = None) -> torch.Tensor:
    """The kernel's function in plain PyTorch: a float32 masked softmax with
    masked scores at -1e30, masked weights forced to 0 and the row sum
    clamped at 1e-20, cast to q's dtype."""
    B, Sq, H, hd = q.shape
    group = H // k.shape[2]
    kf = k.float().repeat_interleave(group, dim=2)
    vf = v.float().repeat_interleave(group, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kf) * hd**-0.5
    ok = _mask(Sq, k.shape[1], causal, window, q.device)
    s = s.masked_fill(~ok, NEG_INF)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True)).masked_fill(~ok, 0.0)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-20)
    o = torch.einsum("bhqk,bkhd->bhqd", p, vf) / l
    return o.transpose(1, 2).to(q.dtype)


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise ValueError(what)


def tma_strides(t: torch.Tensor) -> tuple:
    """The (batch, seq, head) strides, in elements, of a bf16 tensor
    ``(B, S, heads, hd)`` that the tensor-core route reads through a TMA
    tensor map. Raises ``ValueError`` where TMA's 16-byte rule breaks: the
    base address, or the byte stride of a dim longer than 1, not a positive
    multiple of 16. A dim of length 1 is never stepped, so its stride is given as
    ``hd`` (a multiple of 8 elements for every head dim in ``HEAD_DIMS``)."""
    _check(t.data_ptr() % 16 == 0,
           "flash_attention's bf16 route needs 16-byte-aligned q, k and v (TMA)")
    strides = []
    for n, st in zip(t.shape[:3], t.stride()[:3]):
        _check(n == 1 or (st > 0 and (st * t.element_size()) % 16 == 0),
               f"flash_attention's bf16 route needs strides of multiples of 16 bytes (TMA), "
               f"not {tuple(t.stride())} for shape {tuple(t.shape)}")
        strides.append(st if n > 1 else t.shape[3])
    return tuple(strides)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None) -> torch.Tensor:
    """Causal or windowed GQA attention, q ``(B, Sq, H, hd)``, k/v
    ``(B, Skv, KH, hd)`` -> ``(B, Sq, H, hd)`` in q's dtype."""
    _check(q.dim() == 4 and k.dim() == 4 and v.dim() == 4,
           "flash_attention takes q (B, Sq, H, hd) and k, v (B, Skv, KH, hd)")
    B, Sq, H, hd = q.shape
    _check(k.shape == v.shape and k.shape[0] == B and k.shape[3] == hd,
           f"k {tuple(k.shape)} and v {tuple(v.shape)} do not fit q {tuple(q.shape)}")
    Skv, KH = k.shape[1], k.shape[2]
    _check(min(B, Sq, H, hd, Skv, KH) > 0 and H % KH == 0,
           f"flash_attention needs nonempty shapes and H % KH == 0, not H={H} KH={KH}")
    _check(q.dtype in DTYPES and k.dtype == q.dtype and v.dtype == q.dtype,
           f"flash_attention takes bfloat16 or float32 alike, not {q.dtype}/{k.dtype}/{v.dtype}")
    _check(q.device == k.device == v.device, "q, k and v must lie on one device")
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window)
    _check(q.device.type == "cuda", f"flash_attention takes CPU or CUDA tensors, not {q.device}")
    _check(hd in HEAD_DIMS, f"the flash-attention kernel is built for head dims {HEAD_DIMS}, not {hd}")
    _check(q.stride(3) == k.stride(3) == v.stride(3) == 1,
           "flash_attention needs the head dim contiguous")
    bf16 = q.dtype == torch.bfloat16
    strides = [tma_strides(t) if bf16 else t.stride()[:3] for t in (q, k, v)]
    out = torch.empty((B, Sq, H, hd), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        err = _lib().repro_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            int(bf16), B, Sq, Skv, H, KH, hd, *strides[0], *strides[1], *strides[2],
            int(causal), int(window is not None), 0 if window is None else int(window),
            hd**-0.5, torch.cuda.current_stream().cuda_stream)
    backend.check_launch("flash_attention", err)
    flash_attention.launches += 1
    flash_attention.shape_launches[(tuple(q.shape), tuple(k.shape), bool(causal))] += 1
    return out


flash_attention.launches = 0
flash_attention.shape_launches = Counter()
