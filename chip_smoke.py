#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (Hopper, sm_90a).

Run from the root of the repository, with no arguments:

    python3 chip_smoke.py

Phases, each of which exits non-zero on any failed check:

1. backend: the report of ``python -m repro_torch.backend``, then the build of
   every kernel from ``src/repro_torch/kernels/*/csrc`` with ``nvcc`` (one per
   source, started together) and each library's ``ptxas`` register lines;
2. quantize kernels: each against its plain PyTorch version on the card, at
   the shapes of the connection path — the gradient of one llama3.2-1b
   decoder layer at its published widths (d_model 2048, 32 heads and 8 KV
   heads of 64, d_ff 8192: 60,821,504 float32) at blocks 256 and 64 — and at
   blocks 4, 128, 1024, a ragged tail, block 101 and an offset view, each
   byte- or bit-equal and on the route the wrapper must choose (vector for
   aligned powers of two, else scalar); then timed with CUDA events at
   blocks 256 and 64 beside the plain version and the bound of the card's
   memory rate, and each route through its C entry point, in turns, with
   its GB/s and share of the bound;
3. flash attention: the tensor-core kernel's ptxas registers and spills
   (0 spill bytes required) and its wgmma and TMA instructions in the built
   library (``cuobjdump -sass``: HGMMA and UTMALDG, both nonzero); then the
   kernel against its plain version at the serving path's prefill shape (q
   4 x 2048 x 32 x 64, k/v 4 x 2048 x 8 x 64, bf16, causal), a ragged
   length, a 1024 window, non-causal, float32, head dim 128 and hymba's two
   GQA-5 shapes, each within its stated tolerance; then timed, with TFLOP/s
   and the share of the card's bound, at llama's prefill shape (beside the
   plain version), hymba's two and a head dim of 128, each beside
   ``scaled_dot_product_attention`` (a yardstick the port never calls);
4. connection path: two host agents negotiate a Select of two int8 wires
   (block 256, block 64), stream the layer's gradients as two batches, swap
   the wire under two-phase commit and stream them again. The quantize
   kernels' launch counters are set to 0 just before and read just after:
   2 launches of each kernel at each block, all on the vector route.
   The same run is then repeated under torch.profiler for the device's idle
   share;
5. WAN path: the same two batches, each flattened to one tensor on the card,
   through a ``WanLinkChunnel`` pair (block 256, MTU 4096, window 8) on a
   clean link: 2 launches of each quantize kernel, all on the vector route,
   the received tensors bit-equal to the plain round trip and the wire
   payload byte-equal to the plain encode; then the attention batch again
   over a link that drops 2% of frames (retransmits, no failed send, the
   same bits); then the chaos-regions scenario (``tests/torch_chaos_regions.py``)
   with the WAN links, the gateway and the tensor blob on the card: its
   acceptance predicates, one quantize launch per blob sent, one unpack
   launch per blob the gateway decoded, and no exception in any thread;
6. serving path: ``python -m repro_torch.launch.serve --arch llama3.2-1b
   --batch 4 --prompt-len 2048 --gen 32`` through its ``main``, at the full
   published config (16 layers, 1,235,814,400 float32 parameters drawn from
   a seed), with the flash kernel's counter set to 0 just before and read
   just after: one launch per layer of the prefill, none in decode. Then, on
   a model built again from the same seed: the prefill's logits against the
   same prefill with plain dense attention, decode step 1's logits against
   a prefill over the S + 1 tokens, warm timings, and a profile of prefill
   and decode;
7. SSM scan: the kernel against its plain version on the card at the
   hybrid serving path's prefill chunk (a, bx 4 x 256 x 3200 x 16 float32),
   its decode step (C = 1), a d_in of 300, a chunk that is a strided view of
   a longer sequence, two half chunks against one whole, and a = 1 against
   a float64 sum, each within 1e-5; then timed beside the plain version and
   the bound of the card's memory rate;
8. hybrid serving path: ``python -m repro_torch.launch.serve --arch
   hymba-1.5b --batch 4 --prompt-len 2048 --gen 32`` through its ``main``, at
   the full published config (32 layers, d_model 1600, 25 heads and 5 KV
   heads of 64, 29 of them with a 1024 window; 1,663,080,000 float32
   parameters drawn from a seed), with the flash and SSM-scan kernels'
   counters set to 0 just before and read just after: one flash launch per
   layer of the prefill and none in decode, one scan launch per chunk of 256
   per layer of the prefill and one per layer of each decode step (256 +
   32 x 32). Then the checks of phase 6, the plain side also scanning with
   the scan's plain version, warm timings and a profile.

The line before the last is one JSON object of the kernels' numbers; the
last is ``{"ok": true, "device": {...}}``. Without a CUDA device, or without
the package beside it, the script exits non-zero and prints no result.
"""
from __future__ import annotations

import json
import math
import re
import statistics
import subprocess
import sys
import threading
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

SEED = 0
GRAD_SCALE = 1e-3
D_MODEL, N_HEADS, N_KV, HEAD_DIM, D_FF = 2048, 32, 8, 64, 8192
#: one decoder layer's parameters, as (name, shape), attention batch then MLP
ATTN = [("q", (N_HEADS * HEAD_DIM, D_MODEL)), ("k", (N_KV * HEAD_DIM, D_MODEL)),
        ("v", (N_KV * HEAD_DIM, D_MODEL)), ("o", (D_MODEL, N_HEADS * HEAD_DIM)),
        ("attn_norm", (D_MODEL,))]
MLP = [("gate", (D_FF, D_MODEL)), ("up", (D_FF, D_MODEL)), ("down", (D_MODEL, D_FF)),
       ("mlp_norm", (D_MODEL,))]
LAYER_NUMEL = 60_821_504
BLOCKS = (256, 64)
REPLACES = {"quantize_pack": "src/repro/kernels/quantize/quantize.py:46",
            "unpack_dequant": "src/repro/kernels/quantize/quantize.py:73"}
SOURCE = "src/repro_torch/kernels/quantize/csrc/quantize.cu"
#: device-memory rate of an H100 SXM (NVIDIA's H100 data sheet), bytes/s
MEMORY_RATE = 3.35e12
#: peak float32 rate outside the tensor cores (H100 SXM data sheet)
F32_OPS_PER_S = 67e12
#: elementwise operations per element: abs, max, divide, round, 2 clamps, and
#: the scale's multiply per row; unpack: convert and multiply
OPS_PER_ELEM = {"quantize_pack": 6, "unpack_dequant": 2}
#: dense bf16 tensor-core peak of an H100 SXM (NVIDIA's H100 data sheet)
BF16_OPS_PER_S = 989e12
FLASH_SOURCE = "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu"
FLASH_REPLACES = "src/repro/kernels/flash_attention/flash_attention.py:109"
SSM_SOURCE = "src/repro_torch/kernels/ssm_scan/csrc/ssm_scan.cu"
SSM_REPLACES = "src/repro/kernels/ssm_scan/ssm_scan.py:57"
#: hymba-1.5b's attention (25 query heads over 5 KV heads, window 1024) and
#: SSM scan widths (d_in = 2 x 1600, state 16), and the prefill's scan chunk
HYMBA_HEADS, HYMBA_KV, HYMBA_WINDOW = 25, 5, 1024
SSM_D_IN, SSM_N, SSM_CHUNK = 3200, 16, 256
#: scan kernel against its plain version: the reference's own atol = rtol
#: (tests/test_kernels.py::TestSsmScanKernel)
SSM_TOL = 1e-5
#: the serving path: four prompts of 2048 tokens, then 32 decode steps
SERVE_BATCH, SERVE_PROMPT, SERVE_GEN = 4, 2048, 32
#: kernel against plain version. bfloat16 (the tensor-core route): atol = rtol
#: = 1e-2, as torch.testing.assert_close takes them; the route rounds p to
#: bf16 for P.V, which moves outputs by up to one bf16 step at their
#: magnitude (0.0156 at |o| of 2 to 4). float32 (the SIMT route): max abs
#: error 2e-5, summation order. Both tighter than the reference's own 2e-2 /
#: 2e-3 (tests/test_kernels.py)
FLASH_TOL = {"bfloat16": 1e-2, "float32": 2e-5}
#: the mangled name's stem of the tensor-core kernel, in ptxas's log
FLASH_TC_KERNEL = "flash_attention_tc_kernel"
#: serving checks, max abs error on logits of magnitude up to about 5: the
#: kernel's and the dense path's bf16 attention outputs differ by a rounding
#: step, and 16 layers of bf16 residual stream carry it to the logits
LOGITS_TOL = 0.1
#: hymba's serving checks, max abs error on logits of the same magnitude: the
#: scan kernel agrees with its plain version bit for bit, so the difference
#: is again the flash kernel's bf16 rounding step against the dense path,
#: now carried by 32 layers of bf16 residual (twice llama's 16), through
#: each layer's two normalised branches
HYMBA_LOGITS_TOL = 0.15
#: the WAN phase: the chunnel's own MTU, its window, block 256, and the loss
#: of the lossy rerun's link
WAN_BLOCK, WAN_MTU, WAN_WINDOW, WAN_LOSS = 256, 4096, 8, 0.02
#: exceptions raised in any thread (the WAN receiver, the gateway's loop)
THREAD_ERRORS: list = []


def _record_thread_error(args) -> None:
    THREAD_ERRORS.append(f"{args.thread.name if args.thread else '?'}: "
                         f"{args.exc_type.__name__}: {args.exc_value}")
    traceback.print_exception(args.exc_type, args.exc_value, args.exc_traceback)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def check(ok: bool, msg: str) -> None:
    if not ok:
        fail(msg)


def time_ms(torch, fn, reps: int = 21, group: int = 5) -> float:
    """Median over ``reps`` of the mean time of ``group`` back-to-back calls,
    from CUDA events, after a warm-up."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(group):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / group)
    return statistics.median(times)


def within_half_scale(torch, x, y, s):
    """|x - y| <= s/2 + 2 ulp per element, s the row's scale: rint's half
    step, plus the rounding of x / s (at most 1 ulp of x once scaled back)
    and of q * s (half an ulp of y)."""
    mag = torch.maximum(x.abs(), y.abs())
    ulp = torch.nextafter(mag, torch.full_like(mag, float("inf"))) - mag
    return (x - y).abs() <= s[:, None] / 2 + 2 * ulp


def layer_grads(torch, spec, gen):
    return [torch.randn(shape, generator=gen, device="cuda") * GRAD_SCALE
            for _, shape in spec]


def phase_backend(torch, backend) -> str:
    rep = backend.report()
    print("backend:", json.dumps(rep))
    check(rep["capability"] == [9, 0], f"capability {rep['capability']}, want [9, 0]")
    t0 = time.monotonic()
    secs = backend.build_kernels()
    print(f"build: {json.dumps(secs)} total {time.monotonic() - t0:.3f}s")
    for name in secs:
        log = backend.lib_path(name).with_suffix(".log")
        lines = [ln for ln in log.read_text().splitlines() if "Used" in ln or "spill" in ln]
        print(f"ptxas {name}:", " | ".join(ln.strip() for ln in lines))
    return rep["nvidia_smi"]


def phase_kernels(torch) -> dict:
    from repro_torch.kernels.quantize.quantize import (
        launch, packed_nbytes, quantize_pack, quantize_pack_ref, unpack_dequant,
        unpack_dequant_ref)

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    flat = torch.cat([g.reshape(-1) for g in layer_grads(torch, ATTN + MLP, gen)])
    check(flat.numel() == LAYER_NUMEL, f"layer payload {flat.numel()} f32")
    ragged = LAYER_NUMEL - 77
    n_attn = sum(math.prod(shape) for _, shape in ATTN)
    # (label, block, floats, bytes the packed buffer is moved off a 16-byte
    # boundary before unpacking): the whole layer (timed at the main path's
    # blocks) and the main path's two batches at both of its blocks, the
    # layer at the vector route's smallest, a middle and its largest block,
    # a ragged tail padded as encode_batch pads it, a block that puts the
    # scales at an odd byte, and an offset view (floats one float and a
    # packed buffer one byte past a 16-byte boundary), which takes the scalar
    # route
    cases = [(label, block, x, 0) for block in BLOCKS for label, x in
             (("layer", flat), ("attention batch", flat[:n_attn]), ("mlp batch", flat[n_attn:]))]
    cases += [("layer", block, flat, 0) for block in (4, 128, 1024)]
    cases += [("ragged", 256, torch.nn.functional.pad(flat[:ragged], (0, (-ragged) % 256)), 0),
              ("odd-block", 101, flat[:101 * 9999].clone(), 0),
              ("offset view", 64, flat[1:1 + 64 * 9999], 1)]
    results = {}
    for label, block, x, shift in cases:
        x2d = x.view(-1, block)
        n_blocks = x2d.shape[0]
        want = "scalar" if label in ("odd-block", "offset view") else "vector"
        check((x2d.data_ptr() % 16 == 4) == (label == "offset view"),
              f"{label}: floats at data_ptr % 16 = {x2d.data_ptr() % 16}")
        n0 = quantize_pack.route_launches.copy()
        packed = quantize_pack(x2d)
        packed_ref = quantize_pack_ref(x2d)
        torch.cuda.synchronize()
        check(quantize_pack.route_launches - n0 == {(want, block): 1},
              f"quantize_pack at {label} b{block}: want one {want} launch")
        check(packed.shape == (packed_nbytes(n_blocks, block),), "packed shape")
        q_err = (packed.int() - packed_ref.int()).abs().max().item()
        check(torch.equal(packed, packed_ref),
              f"quantize_pack != plain at {label} b{block}: max byte diff {q_err}")
        q_route = want
        src = packed
        if shift:
            src = torch.empty(packed.numel() + shift, dtype=torch.uint8, device="cuda")[shift:]
            src.copy_(packed)
        check(src.data_ptr() % 16 == shift, f"{label}: packed at data_ptr % 16 = "
              f"{src.data_ptr() % 16}, want {shift}")
        n0 = unpack_dequant.route_launches.copy()
        y = unpack_dequant(src, n_blocks, block)
        y_ref = unpack_dequant_ref(packed, n_blocks, block)
        torch.cuda.synchronize()
        check(unpack_dequant.route_launches - n0 == {(want, block): 1},
              f"unpack_dequant at {label} b{block}: want one {want} launch")
        d_err = (y - y_ref).abs().max().item()
        check(torch.equal(y.view(torch.int32), y_ref.view(torch.int32)),
              f"unpack_dequant != plain at {label} b{block}: max abs diff {d_err}")
        s = packed[n_blocks * block:].clone().view(torch.float32)
        check(bool(within_half_scale(torch, x2d, y.view(n_blocks, block), s).all()),
              f"error above scale/2 at {label}")
        print(f"kernel check {label} b{block}: n_blocks {n_blocks}, data_ptr % 16 of floats "
              f"{x2d.data_ptr() % 16} and packed {src.data_ptr() % 16}, routes {q_route} and "
              f"{want}: byte-equal, bit-equal")
        if label != "layer" or block not in BLOCKS:
            continue
        n = x2d.numel()
        io = {"quantize_pack": 4 * n + packed.numel(), "unpack_dequant": packed.numel() + 4 * n}
        y_out = torch.empty_like(y)
        args = {"quantize_pack": (x2d, torch.empty_like(packed)), "unpack_dequant": (packed, y_out)}
        times = {
            "quantize_pack": (time_ms(torch, lambda: quantize_pack(x2d)),
                              time_ms(torch, lambda: quantize_pack_ref(x2d))),
            "unpack_dequant": (time_ms(torch, lambda: unpack_dequant(packed, n_blocks, block)),
                               time_ms(torch, lambda: unpack_dequant_ref(packed, n_blocks, block))),
        }
        for name, (ms, plain_ms) in times.items():
            # both routes through their C entry points, in turns: vector,
            # scalar, scalar, vector; the lower of each route's two times
            route_ms = {"vector": [], "scalar": []}
            for which in ("vector", "scalar", "scalar", "vector"):
                route_ms[which].append(time_ms(
                    torch, lambda: launch(name, which, *args[name], n_blocks, block)))
            route_ms = {which: min(t) for which, t in route_ms.items()}
            bytes_ms = io[name] / MEMORY_RATE * 1e3
            ops_ms = OPS_PER_ELEM[name] * n / F32_OPS_PER_S * 1e3
            bound = max(bytes_ms, ops_ms)
            results[(name, block)] = {
                "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
                "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
                "bytes": io[name], "max_abs_err": q_err if name == "quantize_pack" else d_err,
                "routes": {which: {"ms": t, "share_of_bound": bound / t}
                           for which, t in route_ms.items()}}
            print(f"time {name} b{block}: {ms:.4f} ms (plain {plain_ms:.4f} ms, "
                  f"bound {bound:.4f} ms, {io[name]} bytes, "
                  f"{io[name] / ms / 1e6:.1f} GB/s, {bound / ms:.1%} of the bound)")
            for which, t in route_ms.items():
                print(f"time {name} b{block} {which} route: {t:.4f} ms, "
                      f"{io[name] / t / 1e6:.1f} GB/s, {bound / t:.1%} of the bound")
    return results


def phase_flash(torch) -> dict:
    """The flash-attention kernel against its plain version, then timed at
    the serving path's prefill shape."""
    from repro_torch.kernels.flash_attention.flash_attention import (
        flash_attention, flash_attention_ref)

    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)

    def qkv(B, S, hd, dtype, heads=(N_HEADS, N_KV)):
        H, KH = heads
        return [torch.randn(shape, generator=gen, device="cuda").to(dtype)
                for shape in ((B, S, H, hd), (B, S, KH, hd), (B, S, KH, hd))]

    bf16, f32 = torch.bfloat16, torch.float32
    cases = [("prefill", (SERVE_BATCH, SERVE_PROMPT, HEAD_DIM, bf16), dict(causal=True)),
             ("ragged S=2000", (SERVE_BATCH, 2000, HEAD_DIM, bf16), dict(causal=True)),
             ("window 1024", (SERVE_BATCH, SERVE_PROMPT, HEAD_DIM, bf16),
              dict(causal=True, window=1024)),
             ("non-causal", (SERVE_BATCH, SERVE_PROMPT, HEAD_DIM, bf16), dict(causal=False)),
             ("float32", (SERVE_BATCH, SERVE_PROMPT, HEAD_DIM, f32), dict(causal=True)),
             ("hd128", (1, 1024, 128, bf16), dict(causal=True)),
             ("hymba GQA 5, window 1024", (SERVE_BATCH, SERVE_PROMPT, HEAD_DIM, bf16),
              dict(causal=True, window=HYMBA_WINDOW)),
             ("hymba GQA 5, global", (SERVE_BATCH, SERVE_PROMPT, HEAD_DIM, bf16),
              dict(causal=True))]
    errs = {}
    for label, (B, S, hd, dtype), kw in cases:
        q, k, v = qkv(B, S, hd, dtype, (HYMBA_HEADS, HYMBA_KV) if "hymba" in label
                      else (N_HEADS, N_KV))
        out = flash_attention(q, k, v, **kw)
        want = flash_attention_ref(q, k, v, **kw)
        torch.cuda.synchronize()
        check(out.shape == q.shape and out.dtype == dtype, f"flash {label}: {out.dtype} {out.shape}")
        err = (out.float() - want.float()).abs().max().item()
        tol = FLASH_TOL[str(dtype).split(".")[1]]
        if dtype == bf16:
            form = f"atol = rtol = {tol}"
            try:
                torch.testing.assert_close(out.float(), want.float(), atol=tol, rtol=tol)
                ok = True
            except AssertionError:
                ok = False
        else:
            form, ok = f"max abs err <= {tol}", err <= tol
        print(f"kernel check flash_attention {label}: q {tuple(q.shape)} {dtype} {kw} "
              f"max abs err {err} ({form})")
        check(ok, f"flash_attention {label}: max abs err {err}, outside {form}")
        errs[label] = err

    q, k, v = qkv(SERVE_BATCH, SERVE_PROMPT, HEAD_DIM, bf16)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_err = (sdpa(qt, kt, vt, is_causal=True, enable_gqa=True).transpose(1, 2).float()
               - flash_attention_ref(q, k, v).float()).abs().max().item()
    ms = time_ms(torch, lambda: flash_attention(q, k, v, causal=True))
    plain_ms = time_ms(torch, lambda: flash_attention_ref(q, k, v, causal=True), reps=5, group=2)
    library_ms = time_ms(torch, lambda: sdpa(qt, kt, vt, is_causal=True, enable_gqa=True))
    res = {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
           "max_abs_err": errs["prefill"], **flash_bound(q, k, None)}
    print(f"time flash_attention prefill: {ms:.4f} ms (plain {plain_ms:.4f} ms, "
          f"sdpa {library_ms:.4f} ms, sdpa vs plain max abs err {lib_err}, "
          f"bound {res['bound_ms']:.4f} ms by {res['bound_by']}: {res['flops']} flops at "
          f"{BF16_OPS_PER_S / 1e12:.0f} TFLOP/s, {res['bytes']} bytes; "
          f"{res['flops'] / ms / 1e9:.1f} TFLOP/s, {res['bound_ms'] / ms:.1%} of the bound)")

    # hymba's two prefill shapes (29 layers with the window, 3 without), then
    # head dim 128 (mistral-nemo's width) at llama's batch, length and heads
    timed = [("hymba window 1024", (HYMBA_HEADS, HYMBA_KV), HEAD_DIM, HYMBA_WINDOW),
             ("hymba global", (HYMBA_HEADS, HYMBA_KV), HEAD_DIM, None),
             ("hd128", (N_HEADS, N_KV), 128, None)]
    pos = torch.arange(SERVE_PROMPT, device="cuda")
    for label, heads, hd, window in timed:
        q, k, v = qkv(SERVE_BATCH, SERVE_PROMPT, hd, bf16, heads)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        ms = time_ms(torch, lambda: flash_attention(q, k, v, causal=True, window=window))
        # sdpa's boolean mask keeps True: causal and inside the window
        mask = None if window is None else (
            (pos[None, :] <= pos[:, None]) & (pos[:, None] - pos[None, :] < window))
        lib = time_ms(torch, lambda: sdpa(qt, kt, vt, attn_mask=mask, is_causal=window is None,
                                          enable_gqa=True))
        b = flash_bound(q, k, window)
        res[label] = {"ms": ms, "library_ms": lib, **b}
        print(f"time flash_attention {label}: q {tuple(q.shape)} bf16: {ms:.4f} ms "
              f"(sdpa {lib:.4f} ms, bound {b['bound_ms']:.4f} ms by {b['bound_by']}: "
              f"{b['flops']} flops, {b['bytes']} bytes; {b['flops'] / ms / 1e9:.1f} TFLOP/s, "
              f"{b['bound_ms'] / ms:.1%} of the bound)")
    return res


def flash_bound(q, k, window) -> dict:
    """The least time of causal attention over q and k's shapes: 4 flops per
    kept (q, k) pair and head dim (QK^T and PV) at the bf16 tensor-core
    peak, against q, k, v read and o written once at the memory rate."""
    B, S, H, hd = q.shape
    pairs = sum(min(i + 1, window or i + 1) for i in range(S))
    flops = 4 * B * H * hd * pairs
    io = 2 * (2 * q.numel() + 2 * k.numel())
    ops_ms, bytes_ms = flops / BF16_OPS_PER_S * 1e3, io / MEMORY_RATE * 1e3
    return {"bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "flops": flops, "bytes": io}


def flash_build_report(backend) -> None:
    """The tensor-core kernel's registers and spills from ptxas's log, and
    the count of wgmma (HGMMA) and TMA-load (UTMALDG) instructions in the
    built library from ``cuobjdump -sass``: 0 spill bytes, and both nonzero."""
    lib = backend.lib_path("flash_attention")
    func, props = None, {}
    for line in lib.with_suffix(".log").read_text().splitlines():
        if "Compiling entry function" in line:
            func = line.split("'")[1]
        elif func and FLASH_TC_KERNEL in func and ("spill" in line or "Used" in line):
            props.setdefault(func, []).append(line.strip())
    check(len(props) == 4, f"ptxas reported {len(props)} instantiations of {FLASH_TC_KERNEL}")
    for func, lines in props.items():
        print(f"ptxas {FLASH_TC_KERNEL} {func.split('ILi')[1].split('E')[0]}:", " | ".join(lines))
        spills = [int(n) for ln in lines for n in re.findall(r"(\d+) bytes spill", ln)]
        check(len(spills) == 2 and sum(spills) == 0, f"{func}: spill bytes in {lines}")
    cuobjdump = Path(backend.nvcc_path()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib)], capture_output=True, text=True,
                          timeout=300).stdout
    counts = {op: sass.count(op) for op in ("HGMMA", "UTMALDG")}
    print(f"sass flash_attention library: {json.dumps(counts)}")
    check(all(counts.values()), f"the flash library lacks wgmma or TMA loads: {counts}")


def _quantize_counts() -> dict:
    """Launches of each quantize kernel, and by route and block, since the
    counters were last set to 0."""
    from repro_torch.kernels.quantize.quantize import quantize_pack, unpack_dequant

    return {w.__name__: (w.launches, {f"{which} b{block}": n for (which, block), n
                                       in w.route_launches.items()})
            for w in (quantize_pack, unpack_dequant)}


def _reset_quantize_counts() -> None:
    from repro_torch.kernels.quantize.quantize import quantize_pack, unpack_dequant

    for w in (quantize_pack, unpack_dequant):
        w.launches = 0
        w.route_launches.clear()


def phase_main_path(torch) -> dict:
    from repro_torch.comm.session import run_swap_session
    from repro_torch.kernels.quantize.quantize import INV127

    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    batches = [layer_grads(torch, ATTN, gen), layer_grads(torch, MLP, gen)]
    torch.cuda.synchronize()
    _reset_quantize_counts()
    res = run_swap_session(batches + batches, blocks=BLOCKS, swap_after=2, device="cuda")
    counts = _quantize_counts()
    launches = {name: n for name, (n, _) in counts.items()}
    by_route = {name: routes for name, (_, routes) in counts.items()}
    print(f"main path: wire blocks client {res.client_blocks} server {res.server_blocks}, "
          f"switches {res.client_switches}/{res.server_switches}, launches {launches}, "
          f"by route and block {json.dumps(by_route)}")
    check(res.swapped and res.client_switches == 1 and res.server_switches == 1,
          "the 2PC swap did not happen exactly once on both sides")
    check(res.client_blocks == [256, 256, 64, 64] == res.server_blocks,
          "both wires must carry traffic, the swap between batch 2 and 3")
    check(launches == {"quantize_pack": 4, "unpack_dequant": 4},
          f"launches {launches}: want one encode and one decode per batch")
    check(all(r == {"vector b256": 2, "vector b64": 2} for r in by_route.values()),
          f"launches by route {by_route}: want all 8 on the vector route, 2 per kernel and block")
    for sent, got, block in zip(batches + batches, res.received, res.client_blocks):
        check(len(got) == len(sent), "tensors lost")
        for a, b in zip(sent, got):
            check(b.device.type == "cuda" and b.shape == a.shape and b.dtype == torch.float32,
                  f"got {b.dtype} {tuple(b.shape)} on {b.device}, sent {tuple(a.shape)}")
        flat = torch.cat([a.reshape(-1) for a in sent])
        flat = torch.nn.functional.pad(flat, (0, (-flat.numel()) % block)).view(-1, block)
        s = flat.abs().amax(dim=1) * INV127
        s = torch.where(s > 0, s, torch.ones_like(s))
        y = torch.cat([b.reshape(-1) for b in got])
        y = torch.nn.functional.pad(y, (0, flat.numel() - y.numel())).view(-1, block)
        check(bool(torch.isfinite(y).all()), "non-finite values received")
        check(bool(within_half_scale(torch, flat, y, s).all()),
              f"a received value is off by more than scale/2 at block {block}")
    payload = sum(a.numel() * 4 for batch in batches + batches for a in batch)
    gbps = payload / res.seconds / 1e9
    print(f"main path: {payload} payload bytes in {res.seconds:.4f} s = {gbps:.3f} GB/s "
          f"through the connection, 2PC swap included")
    return launches, by_route, batches


def device_events(torch, prof) -> list:
    """(device us, name, count) of a profile, largest first. Device-side events
    only: a host op (aten::copy_) also carries the device time of the copy it
    launched, and would count it twice."""
    return sorted(((e.self_device_time_total, e.key, e.count) for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA), reverse=True)


def phase_profile(torch, batches) -> None:
    """The main path once more under torch.profiler: the device's busy time
    (kernels and copies) against the wall time of the run, and the count of
    launches and copies per batch."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.comm.session import run_swap_session

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        res = run_swap_session(batches + batches, blocks=BLOCKS, swap_after=2,
                               device="cuda")
    dev = device_events(torch, prof)
    busy_s = sum(us for us, _, _ in dev) / 1e6
    print(f"profile: wall {res.seconds:.4f} s, device busy {busy_s:.4f} s, "
          f"idle share {1 - busy_s / res.seconds:.4f}")
    for us, key, count in dev[:8]:
        print(f"profile: device {us / 1e3:.3f} ms in {count} x {key}")
    # the cost contract of a batch whose tensors lie on the card: one launch
    # and one device-to-host copy to send, one host-to-device copy and one
    # launch to receive; every launch the vector route's
    n = len(batches) * 2
    for part, want in (("quantize_pack", n), ("unpack_dequant", n),
                       ("quantize_pack_vec_kernel", n), ("unpack_dequant_vec_kernel", n),
                       ("Memcpy DtoH", n), ("Memcpy HtoD", n)):
        got = sum(c for _, k, c in dev if part in k)
        check(got == want, f"profile: {got} x {part} in {n} batches, want {want}")


def _wan_send(torch, xs, loss: float = 0.0) -> dict:
    """Each tensor of ``xs`` in its own ``send([t])`` through a fresh
    ``WanLinkChunnel`` pair on the card, a thread pumping the receiver; the
    receiver's reassembled payloads are kept. Returns what arrived, the
    payloads, the sender's counters and the wall time from the first send to
    the last tensor received and synchronised."""
    from repro_torch.comm.chunnels import WanLinkChunnel
    from repro_torch.core.fabric import Fabric, LinkModel

    fabric = Fabric(seed=SEED)
    if loss:
        for a, b in (("wan-tx", "wan-rx"), ("wan-rx", "wan-tx")):
            fabric.set_link(a, b, LinkModel(loss=loss))
    kw = dict(mtu_bytes=WAN_MTU, window=WAN_WINDOW, block=WAN_BLOCK, device="cuda")
    tx = WanLinkChunnel(fabric.register("wan-tx"), "wan-rx", **kw).connect_wrap(None)
    rx = WanLinkChunnel(fabric.register("wan-rx"), "wan-tx", **kw).connect_wrap(None)
    payloads, got = [], []
    ingest = rx._reasm.ingest

    def keep(frame):
        done = ingest(frame)
        if done is not None:
            payloads.append(done[0])
        return done

    rx._reasm.ingest = keep

    def pump():
        buf = [None]
        deadline = time.monotonic() + 300.0
        while len(got) < len(xs) and time.monotonic() < deadline:
            if rx.recv(buf, timeout=0.05):
                got.append(buf[0])

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    receiver = threading.Thread(target=pump, name="wan-receiver")
    receiver.start()
    for x in xs:
        tx.send([x])
    receiver.join(timeout=330.0)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    check(not receiver.is_alive() and len(got) == len(xs),
          f"WAN link: {len(got)} of {len(xs)} tensors arrived")
    frames_each = [-(-(len(pl)) // WAN_MTU) for pl in payloads]
    return {"got": got, "payloads": payloads, "stats": tx.stats(), "seconds": seconds,
            "windows": sum(-(-n // WAN_WINDOW) for n in frames_each)}


def _check_wan_bits(torch, label, xs, res) -> int:
    """Every received tensor bit-equal to the plain round trip on the card,
    and the reassembled wire payloads byte-equal to the plain encode; returns
    the count of differing payload bytes (0 required)."""
    import numpy as np

    from repro_torch.kernels.quantize.quantize import quantize_pack_ref, unpack_dequant_ref

    check(len(res["payloads"]) == len(xs), f"{label}: {len(res['payloads'])} blobs reassembled")
    differing = 0
    for x, y, payload in zip(xs, res["got"], res["payloads"]):
        x2d = torch.nn.functional.pad(x.reshape(-1), (0, (-x.numel()) % WAN_BLOCK)).view(
            -1, WAN_BLOCK)
        packed = quantize_pack_ref(x2d)
        want = unpack_dequant_ref(packed, x2d.shape[0], WAN_BLOCK)[:x.numel()].view(x.shape)
        check(isinstance(y, torch.Tensor) and y.device.type == "cuda"
              and y.dtype == torch.float32 and y.shape == x.shape,
              f"{label}: received {type(y).__name__} {getattr(y, 'dtype', None)} "
              f"{tuple(getattr(y, 'shape', ()))}, sent {tuple(x.shape)}")
        check(torch.equal(y.view(torch.int32), want.view(torch.int32)),
              f"{label}: received tensor differs from the plain round trip")
        plain = np.frombuffer(packed.cpu().numpy().tobytes(), np.uint8)
        wire = np.frombuffer(payload, np.uint8)
        check(wire.size == plain.size, f"{label}: payload of {wire.size} bytes, plain {plain.size}")
        differing += int((wire != plain).sum())
    check(differing == 0, f"{label}: {differing} payload bytes differ from the plain encode")
    return differing


def phase_wan(torch) -> dict:
    """The WAN path on the card: the layer gradient at full width through a
    WAN link pair, the attention batch again over a lossy link, then the
    chaos-regions scenario. Returns the quantize launches of the three."""
    sys.path.insert(0, str(ROOT / "tests"))
    from torch_chaos_regions import assert_regions_acceptance, reference_blob, run_chaos_regions

    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    xs = [torch.cat([g.reshape(-1) for g in layer_grads(torch, spec, gen)]) for spec in (ATTN, MLP)]
    check([x.numel() for x in xs] == [10_487_808, 50_333_696], "WAN batch sizes")
    total = {"quantize_pack": 0, "unpack_dequant": 0}
    want_routes = {"vector b256": 2}

    def count(label, want_launches):
        counts = _quantize_counts()
        for name, (n, routes) in counts.items():
            check(n == want_launches[name], f"{label}: {n} {name} launches, want "
                  f"{want_launches[name]}")
            check(set(routes) == {f"vector b{WAN_BLOCK}"} and sum(routes.values()) == n,
                  f"{label}: {name} by route {routes}, want all on the vector route")
            total[name] += n
        check(not THREAD_ERRORS, f"{label}: exceptions in threads: {THREAD_ERRORS}")
        return {name: routes for name, (_, routes) in counts.items()}

    payload = sum(x.numel() * 4 for x in xs)
    _reset_quantize_counts()
    res = _wan_send(torch, xs)
    routes = count("WAN full width", {"quantize_pack": 2, "unpack_dequant": 2})
    check(all(r == want_routes for r in routes.values()), f"WAN full width: routes {routes}")
    differing = _check_wan_bits(torch, "WAN full width", xs, res)
    st = res["stats"]
    wire = sum(len(pl) for pl in res["payloads"])
    print(f"WAN full width: {payload} payload bytes ({wire} wire bytes) in {res['seconds']:.4f} s "
          f"= {payload / res['seconds'] / 1e9:.4f} GB/s payload, {st['frames_sent']} frames in "
          f"{res['windows']} windows of {WAN_WINDOW}, {st['retransmits']} retransmits, "
          f"{st['failed_sends']} failed sends; launches by route {json.dumps(routes)}; "
          f"received bit-equal to the plain round trip, {differing} payload bytes differ")

    _reset_quantize_counts()
    lossy = _wan_send(torch, xs[:1], loss=WAN_LOSS)
    count("WAN lossy", {"quantize_pack": 1, "unpack_dequant": 1})
    _check_wan_bits(torch, "WAN lossy", xs[:1], lossy)
    st = lossy["stats"]
    print(f"WAN lossy (loss {WAN_LOSS} each way): {xs[0].numel() * 4} payload bytes in "
          f"{lossy['seconds']:.4f} s = {xs[0].numel() * 4 / lossy['seconds'] / 1e9:.4f} GB/s "
          f"payload, {st['frames_sent']} frames, {st['retransmits']} retransmits, "
          f"{st['failed_sends']} failed sends; received bit-equal")
    check(st["retransmits"] > 0 and st["failed_sends"] == 0,
          f"WAN lossy: retransmits {st['retransmits']}, failed sends {st['failed_sends']}")

    _reset_quantize_counts()
    t0 = time.perf_counter()
    scen = run_chaos_regions(fast=True, device="cuda",
                             blob=torch.from_numpy(reference_blob()).cuda())
    seconds = time.perf_counter() - t0
    try:
        assert_regions_acceptance(scen)
    except AssertionError as e:
        fail(f"WAN scenario: acceptance predicate failed: {e}")
    gw, ls = scen["gateway"], scen["wan"]["link_stats"]
    sent = scen["wan"]["blobs_sent"]
    routes = count("WAN scenario", {"quantize_pack": sent, "unpack_dequant": gw["wan_blobs"]})
    check(sent >= gw["wan_blobs"] >= 1, f"WAN scenario: {sent} blobs sent, "
          f"{gw['wan_blobs']} decoded by the gateway")
    print(f"WAN scenario (chaos regions, fast): {seconds:.4f} s; WAN region switched at tick "
          f"{scen['wan']['switch_tick']}, storm at {scen['storm_tick']}; {sent} blobs sent, "
          f"{gw['wan_blobs']} decoded by the gateway; link retransmits {ls['retransmits']}, "
          f"failed sends {ls['failed_sends']}, keepalive failures {ls['keepalive_failures']}; "
          f"launches by route {json.dumps(routes)}")
    return total


def phase_ssm_scan(torch) -> dict:
    """The SSM-scan kernel against its plain version on the card, then timed
    at the hybrid serving path's prefill chunk and decode step."""
    from repro_torch.kernels.ssm_scan.ssm_scan import ssm_scan_chunk, ssm_scan_chunk_ref

    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)

    def inputs(B, C, d, h0_scale=0.1):
        """The reference's test inputs: a = sigmoid(normal), a decay in
        (0, 1); bx and h0 normal, scaled."""
        a = torch.sigmoid(torch.randn((B, C, d, SSM_N), generator=gen, device="cuda"))
        bx = torch.randn((B, C, d, SSM_N), generator=gen, device="cuda") * 0.1
        h0 = torch.randn((B, d, SSM_N), generator=gen, device="cuda") * h0_scale
        return a, bx, h0

    def compare(label, got, want) -> float:
        torch.cuda.synchronize()
        err = max((g - w).abs().max().item() for g, w in zip(got, want))
        ok = all(torch.allclose(g, w, atol=SSM_TOL, rtol=SSM_TOL) for g, w in zip(got, want))
        print(f"kernel check ssm_scan_chunk {label}: max abs err {err} "
              f"(atol = rtol = {SSM_TOL})")
        check(ok, f"ssm_scan_chunk {label}: max abs err {err} above atol = rtol = {SSM_TOL}")
        return err

    B = SERVE_BATCH
    prefill, decode = inputs(B, SSM_CHUNK, SSM_D_IN), inputs(B, 1, SSM_D_IN)
    errs = []
    for label, (a, bx, h0) in (("prefill chunk", prefill), ("decode step", decode),
                               ("d_in 300", inputs(3, 8, 300))):
        n0 = ssm_scan_chunk.launches
        got = ssm_scan_chunk(a, bx, h0)
        check(ssm_scan_chunk.launches == n0 + 1, "ssm_scan_chunk: one launch per call")
        check(got[0].shape == a.shape and got[1].shape == h0.shape
              and got[0].dtype == torch.float32, f"ssm_scan_chunk {label}: output shapes")
        errs.append(compare(f"{label} {tuple(a.shape)}", got, ssm_scan_chunk_ref(a, bx, h0)))
    # a chunk that is a view of a longer sequence, as ssm_apply passes it
    a, bx, h0 = inputs(B, 2 * SSM_CHUNK, SSM_D_IN)
    a, bx = a[:, SSM_CHUNK:], bx[:, SSM_CHUNK:]
    check(not a.is_contiguous(), "the strided case must be a view")
    errs.append(compare(f"strided view, batch stride {a.stride(0)}",
                        ssm_scan_chunk(a, bx, h0), ssm_scan_chunk_ref(a, bx, h0)))
    # two half chunks in turn against the whole chunk
    a, bx, h0 = prefill
    half = SSM_CHUNK // 2
    seq1, h1 = ssm_scan_chunk(a[:, :half], bx[:, :half], h0)
    seq2, h2 = ssm_scan_chunk(a[:, half:], bx[:, half:], h1)
    errs.append(compare("two half chunks vs one whole", (torch.cat([seq1, seq2], dim=1), h2),
                        ssm_scan_chunk(a, bx, h0)))
    # a = 1 accumulates: h_last = h0 + sum_t bx_t, against a float64 sum
    _, bx1, h01 = inputs(B, SSM_CHUNK, SSM_D_IN, h0_scale=1.0)
    compare("a = 1 vs h0 + sum bx in float64", ssm_scan_chunk(torch.ones_like(bx1), bx1, h01)[1:],
            ((h01.double() + bx1.double().sum(dim=1)).float(),))

    ms = time_ms(torch, lambda: ssm_scan_chunk(a, bx, h0))
    plain_ms = time_ms(torch, lambda: ssm_scan_chunk_ref(a, bx, h0), reps=5, group=2)
    decode_ms = time_ms(torch, lambda: ssm_scan_chunk(*decode))
    # a and bx read, h_seq written, h0 read and h_last written, float32; a
    # multiply and an add per lane and step
    io = 4 * (3 * a.numel() + 2 * h0.numel())
    flops = 2 * a.numel()
    bytes_ms, ops_ms = io / MEMORY_RATE * 1e3, flops / F32_OPS_PER_S * 1e3
    res = {"ms": ms, "plain_ms": plain_ms, "library_ms": None,
           "bound_ms": max(bytes_ms, ops_ms),
           "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
           "max_abs_err": max(errs), "bytes": io, "flops": flops, "decode_ms": decode_ms}
    print(f"time ssm_scan_chunk prefill chunk {tuple(a.shape)}: {ms:.4f} ms (plain "
          f"{plain_ms:.4f} ms, bound {res['bound_ms']:.4f} ms by {res['bound_by']}: {io} bytes, "
          f"{flops} flops; {io / ms / 1e6:.1f} GB/s); decode step {tuple(decode[0].shape)}: "
          f"{decode_ms:.4f} ms")
    return res


def _wrappers():
    """The serving path's kernel wrappers, by name."""
    from repro_torch.kernels.flash_attention.flash_attention import flash_attention
    from repro_torch.kernels.ssm_scan.ssm_scan import ssm_scan_chunk

    return {"flash_attention": flash_attention, "ssm_scan_chunk": ssm_scan_chunk}


def _counts() -> dict:
    return {name: w.launches for name, w in _wrappers().items()}


def _since(before: dict) -> dict:
    return {name: n - before[name] for name, n in _counts().items()}


def phase_serve(torch, arch: str, n_params: int, tol: float) -> dict:
    """The serving path of ``arch`` through the launcher's ``main``, with the
    kernels' counters set to 0 just before and read just after; then the
    checks and timings on a model built again from the same seed. Returns
    the counts of the ``main`` run."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models.registry import build

    cfg = get_config(arch)
    hybrid = cfg.family == "hybrid"
    L = cfg.num_layers
    # one scan launch per chunk of 256 per layer in prefill, one per layer
    # and decode step; one flash launch per layer of the prefill
    scans = -(-SERVE_PROMPT // SSM_CHUNK) * L if hybrid else 0
    want_main = {"flash_attention": L, "ssm_scan_chunk": scans + SERVE_GEN * L * hybrid}
    argv = ["--arch", arch, "--batch", str(SERVE_BATCH), "--prompt-len",
            str(SERVE_PROMPT), "--gen", str(SERVE_GEN)]
    print(f"serve {arch}: python -m repro_torch.launch.serve", " ".join(argv))
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for w in _wrappers().values():
        w.launches = 0
    res = serve.main(argv)
    launches = _counts()
    print(f"serve {arch}: launches {json.dumps(launches)} (want {json.dumps(want_main)}: one "
          f"flash launch per layer of the prefill and none in decode"
          + (f"; one scan per {SSM_CHUNK}-token chunk and layer of the prefill, one per "
             f"layer and decode step" if hybrid else "")
          + f"); peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
          f"({torch.cuda.max_memory_allocated()} bytes)")
    check(launches == want_main, f"serve {arch}: launches {launches}, want {want_main}")
    check(tuple(res.tokens.shape) == (SERVE_BATCH, SERVE_GEN + 1), "generated tokens' shape")
    check(bool(torch.isfinite(res.logits).all()), "non-finite logits")
    print(f"serve {arch} (first call): prefill {res.prefill_s * 1e3:.3f} ms, decode "
          f"{res.decode_ms_per_token:.4f} ms/token, {res.tokens_per_s:.1f} tokens/s")

    model = build(cfg.replace(attn_impl="pallas"), device="cuda", seed=serve.SEED)
    got_params = sum(p.numel() for p in model.parameters())
    check(got_params == n_params, f"{got_params} parameters, want {n_params}")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    tokens = torch.randint(0, cfg.vocab_size, (SERVE_BATCH, SERVE_PROMPT + 1), generator=gen,
                           device="cuda")
    prompt = tokens[:, :SERVE_PROMPT]

    n0 = _counts()
    cache, logits = model.prefill(prompt)
    got = _since(n0)
    check(got == {"flash_attention": L, "ssm_scan_chunk": scans}, f"one prefill launched {got}")
    # the plain side: dense attention, and the scan's plain version
    model.attn_impl = "xla_dense"
    if hybrid:
        model.ssm_impl = "jnp"
    n0 = _counts()
    _, logits_plain = model.prefill(prompt)
    check(_since(n0) == {"flash_attention": 0, "ssm_scan_chunk": 0},
          "the plain prefill launched a kernel")
    model.attn_impl = "pallas"
    if hybrid:
        model.ssm_impl = "pallas"
    err = (logits.float() - logits_plain.float()).abs().max().item()
    agree = (logits.argmax(-1) == logits_plain.argmax(-1)).float().mean().item()
    plain = "xla_dense" + (" and the plain scan" if hybrid else "")
    print(f"serve {arch} check: prefill logits, kernels vs {plain}: max abs err {err} "
          f"(tolerance {tol}), |logits| max over the real vocab "
          f"{logits[:, :cfg.vocab_size].float().abs().max().item()}, "
          f"argmax agree {agree}")
    check(bool(torch.isfinite(logits).all()), "non-finite prefill logits")
    check(err <= tol, f"{arch}: kernel vs plain prefill logits differ by {err}")

    n0 = _counts()
    _, logits_step = model.decode_step(model.grow_cache(cache, 1), tokens[:, SERVE_PROMPT:])
    got = _since(n0)
    check(got == {"flash_attention": 0, "ssm_scan_chunk": L * hybrid},
          f"one decode step launched {got}")
    _, logits_long = model.prefill(tokens)
    err = (logits_step.float() - logits_long.float()).abs().max().item()
    agree = (logits_step.argmax(-1) == logits_long.argmax(-1)).float().mean().item()
    print(f"serve {arch} check: decode step 1 vs prefill over {SERVE_PROMPT + 1} tokens: max "
          f"abs err {err} (tolerance {tol}), argmax agree {agree}")
    check(err <= tol, f"{arch}: decode vs prefill logits differ by {err}")

    # warm timings of the same model, each phase ending in a synchronise
    warm = serve.serve(model, batch=SERVE_BATCH, prompt_len=SERVE_PROMPT, gen=SERVE_GEN)
    print(f"serve {arch} (warm): prefill {warm.prefill_s * 1e3:.3f} ms, decode "
          f"{warm.decode_ms_per_token:.4f} ms/token, {warm.tokens_per_s:.1f} tokens/s")
    check(torch.equal(warm.tokens, res.tokens), "the same seed served other tokens")

    for label, fn in (("prefill", lambda: model.prefill(prompt)),
                      ("decode x8", lambda: _decode_steps(model, model.grow_cache(cache, 8),
                                                         tokens[:, -1:], 8))):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        dev = device_events(torch, prof)
        busy = sum(us for us, _, _ in dev) / 1e6
        tag = f"profile serve {arch} {label}"
        print(f"{tag}: wall {wall:.4f} s, device busy {busy:.4f} s, "
              f"idle share {1 - busy / wall:.4f}")
        print(f"{tag}: {sum(c for _, _, c in dev)} device kernels and copies")
        for us, key, count in dev[:8]:
            print(f"{tag}: device {us / 1e3:.3f} ms in {count} x {key[:90]}")
        host = sorted(((e.self_cpu_time_total, e.key, e.count) for e in prof.key_averages()
                       if e.device_type == torch.autograd.DeviceType.CPU), reverse=True)
        for us, key, count in host[:6]:
            print(f"{tag}: host {us / 1e3:.3f} ms in {count} x {key[:90]}")
    return launches


def _decode_steps(model, cache, tok, n):
    for _ in range(n):
        cache, logits = model.decode_step(cache, tok)
        tok = logits.argmax(dim=-1, keepdim=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the GPU",
              file=sys.stderr)
        return 2
    try:
        from repro_torch import backend
    except ImportError as e:
        print(f"chip_smoke: the repro_torch package is missing: {e}", file=sys.stderr)
        return 2
    threading.excepthook = _record_thread_error
    smi = phase_backend(torch, backend)
    print(f"memory rate used for the bound: H100 SXM {MEMORY_RATE / 1e12} TB/s")
    timed = phase_kernels(torch)
    flash_build_report(backend)
    flash = phase_flash(torch)
    launches, by_route, batches = phase_main_path(torch)
    phase_profile(torch, batches)
    paths = {"connection": dict(launches), "wan": phase_wan(torch)}
    paths["serve llama3.2-1b"] = phase_serve(torch, "llama3.2-1b", 1_235_814_400, LOGITS_TOL)
    scan = phase_ssm_scan(torch)
    paths["serve hymba-1.5b"] = phase_serve(torch, "hymba-1.5b", 1_663_080_000,
                                            HYMBA_LOGITS_TOL)
    by_path = {name: {path: n[name] for path, n in paths.items() if n.get(name)}
               for name in ("quantize_pack", "unpack_dequant", "flash_attention",
                            "ssm_scan_chunk")}
    print("launches by path:", json.dumps(by_path))
    kernels = []
    # the quantize kernels: the numbers at block 256 on top, and each block
    # of the main path with its launches there and both routes' times
    for name in ("quantize_pack", "unpack_dequant"):
        r = timed[(name, 256)]
        blocks = {str(b): {"launches": by_route[name].get(f"vector b{b}", 0),
                           **{k: timed[(name, b)][k] for k in
                              ("ms", "plain_ms", "bound_ms", "routes")}} for b in BLOCKS}
        kernels.append({"name": name, "route": "cuda", "source": SOURCE,
                        "replaces": REPLACES[name],
                        "launches": launches[name] + paths["wan"][name],
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"], "library_ms": None,
                        "launches_by_path": by_path[name], "launches_by_route": by_route[name],
                        "blocks": blocks})
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    # launches: the count of this slice's path, the hymba serve run
    for name, source, replaces, r in (
            ("flash_attention", FLASH_SOURCE, FLASH_REPLACES, flash),
            ("ssm_scan_chunk", SSM_SOURCE, SSM_REPLACES, scan)):
        kernels.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                        "launches": paths["serve hymba-1.5b"][name],
                        **{k: r[k] for k in keys}, "launches_by_path": by_path[name]})
    check(not THREAD_ERRORS, f"exceptions in threads: {THREAD_ERRORS}")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
