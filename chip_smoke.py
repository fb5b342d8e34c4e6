#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (Hopper, sm_90a).

Run from the root of the repository, with no arguments:

    python3 chip_smoke.py

Three phases, each of which exits non-zero on any failed check:

1. backend: the report of ``python -m repro_torch.backend``, then the build of
   every kernel from ``src/repro_torch/kernels/*/csrc`` with ``nvcc``;
2. kernels: each kernel against its plain PyTorch version on the card, at the
   shapes of the main path — the gradient of one llama3.2-1b decoder layer at
   its published widths (d_model 2048, 32 heads and 8 KV heads of 64,
   d_ff 8192: 60,821,504 float32) — byte- or bit-equal, then timed with CUDA
   events beside the plain version and the bound of the card's memory rate;
3. main path: two host agents negotiate a Select of two int8 wires
   (block 256, block 64), stream the layer's gradients as two batches, swap
   the wire under two-phase commit and stream them again. The kernels'
   launch counters are set to 0 just before and read just after. The same
   run is then repeated under torch.profiler for the device's idle share.

The line before the last is one JSON object of the kernels' numbers; the
last is ``{"ok": true, "device": {...}}``. Without a CUDA device, or without
the package beside it, the script exits non-zero and prints no result.
"""
from __future__ import annotations

import json
import math
import statistics
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

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
        packed_nbytes, quantize_pack, quantize_pack_ref, unpack_dequant,
        unpack_dequant_ref)

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    flat = torch.cat([g.reshape(-1) for g in layer_grads(torch, ATTN + MLP, gen)])
    check(flat.numel() == LAYER_NUMEL, f"layer payload {flat.numel()} f32")
    ragged = LAYER_NUMEL - 77
    n_attn = sum(math.prod(shape) for _, shape in ATTN)
    # the whole layer (timed), the main path's two batches at both of its
    # blocks, a ragged tail padded as encode_batch pads it, and a block that
    # puts the scales at an odd byte
    cases = [(label, block, x) for block in BLOCKS for label, x in
             (("layer", flat), ("attention batch", flat[:n_attn]), ("mlp batch", flat[n_attn:]))]
    cases += [("ragged", 256, torch.nn.functional.pad(flat[:ragged], (0, (-ragged) % 256))),
              ("odd-block", 101, flat[:101 * 9999].clone())]
    results = {}
    for label, block, x in cases:
        x2d = x.view(-1, block)
        n_blocks = x2d.shape[0]
        packed = quantize_pack(x2d)
        packed_ref = quantize_pack_ref(x2d)
        torch.cuda.synchronize()
        check(packed.shape == (packed_nbytes(n_blocks, block),), "packed shape")
        q_err = (packed.int() - packed_ref.int()).abs().max().item()
        check(torch.equal(packed, packed_ref),
              f"quantize_pack != plain at {label} b{block}: max byte diff {q_err}")
        y = unpack_dequant(packed, n_blocks, block)
        y_ref = unpack_dequant_ref(packed, n_blocks, block)
        torch.cuda.synchronize()
        d_err = (y - y_ref).abs().max().item()
        check(torch.equal(y.view(torch.int32), y_ref.view(torch.int32)),
              f"unpack_dequant != plain at {label} b{block}: max abs diff {d_err}")
        s = packed[n_blocks * block:].clone().view(torch.float32)
        check(bool(within_half_scale(torch, x2d, y.view(n_blocks, block), s).all()),
              f"error above scale/2 at {label}")
        print(f"kernel check {label} b{block}: n_blocks {n_blocks} byte-equal, bit-equal")
        if label != "layer":
            continue
        n = x2d.numel()
        io = {"quantize_pack": 4 * n + packed.numel(), "unpack_dequant": packed.numel() + 4 * n}
        times = {
            "quantize_pack": (time_ms(torch, lambda: quantize_pack(x2d)),
                              time_ms(torch, lambda: quantize_pack_ref(x2d))),
            "unpack_dequant": (time_ms(torch, lambda: unpack_dequant(packed, n_blocks, block)),
                               time_ms(torch, lambda: unpack_dequant_ref(packed, n_blocks, block))),
        }
        for name, (ms, plain_ms) in times.items():
            bytes_ms = io[name] / MEMORY_RATE * 1e3
            ops_ms = OPS_PER_ELEM[name] * n / F32_OPS_PER_S * 1e3
            results[(name, block)] = {
                "ms": ms, "plain_ms": plain_ms, "bound_ms": max(bytes_ms, ops_ms),
                "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
                "bytes": io[name], "max_abs_err": q_err if name == "quantize_pack" else d_err}
            print(f"time {name} b{block}: {ms:.4f} ms (plain {plain_ms:.4f} ms, "
                  f"bound {max(bytes_ms, ops_ms):.4f} ms, {io[name]} bytes, "
                  f"{io[name] / ms / 1e6:.1f} GB/s)")
    return results


def phase_main_path(torch) -> dict:
    from repro_torch.comm.session import run_swap_session
    from repro_torch.kernels.quantize.quantize import INV127, quantize_pack, unpack_dequant

    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    batches = [layer_grads(torch, ATTN, gen), layer_grads(torch, MLP, gen)]
    torch.cuda.synchronize()
    quantize_pack.launches = 0
    unpack_dequant.launches = 0
    res = run_swap_session(batches + batches, blocks=BLOCKS, swap_after=2, device="cuda")
    launches = {"quantize_pack": quantize_pack.launches,
                "unpack_dequant": unpack_dequant.launches}
    print(f"main path: wire blocks client {res.client_blocks} server {res.server_blocks}, "
          f"switches {res.client_switches}/{res.server_switches}, launches {launches}")
    check(res.swapped and res.client_switches == 1 and res.server_switches == 1,
          "the 2PC swap did not happen exactly once on both sides")
    check(res.client_blocks == [256, 256, 64, 64] == res.server_blocks,
          "both wires must carry traffic, the swap between batch 2 and 3")
    check(launches == {"quantize_pack": 4, "unpack_dequant": 4},
          f"launches {launches}: want one encode and one decode per batch")
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
    return launches, batches


def phase_profile(torch, batches) -> None:
    """The main path once more under torch.profiler: the device's busy time
    (kernels and copies) against the wall time of the run, and the count of
    launches and copies per batch."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.comm.session import run_swap_session

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        res = run_swap_session(batches + batches, blocks=BLOCKS, swap_after=2,
                               device="cuda")
    # device-side events only: a host op (aten::copy_) also carries the
    # device time of the copy it launched, and would count it twice
    dev = sorted(((e.self_device_time_total, e.key, e.count) for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA), reverse=True)
    busy_s = sum(us for us, _, _ in dev) / 1e6
    print(f"profile: wall {res.seconds:.4f} s, device busy {busy_s:.4f} s, "
          f"idle share {1 - busy_s / res.seconds:.4f}")
    for us, key, count in dev[:8]:
        print(f"profile: device {us / 1e3:.3f} ms in {count} x {key}")
    # the cost contract of a batch whose tensors lie on the card: one launch
    # and one device-to-host copy to send, one host-to-device copy and one
    # launch to receive
    n = len(batches) * 2
    for part, want in (("quantize_pack_kernel", n), ("unpack_dequant_kernel", n),
                       ("Memcpy DtoH", n), ("Memcpy HtoD", n)):
        got = sum(c for _, k, c in dev if part in k)
        check(got == want, f"profile: {got} x {part} in {n} batches, want {want}")


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
    smi = phase_backend(torch, backend)
    print(f"memory rate used for the bound: H100 SXM {MEMORY_RATE / 1e12} TB/s")
    timed = phase_kernels(torch)
    launches, batches = phase_main_path(torch)
    phase_profile(torch, batches)
    kernels = []
    for name in ("quantize_pack", "unpack_dequant"):
        r = timed[(name, 256)]
        kernels.append({"name": name, "route": "cuda", "source": SOURCE,
                        "replaces": REPLACES[name], "launches": launches[name],
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"], "library_ms": None})
    print(json.dumps({"block64": {name: timed[(name, 64)] for name in launches}}))
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
