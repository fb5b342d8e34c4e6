#!/usr/bin/env python3
"""What bounds the flash-attention kernel's bf16 route on the GPU.

Run from the root of the repository, on a machine with one Hopper GPU and
``nvcc``:

    python3 scripts/flash_probe.py

It builds variants of ``src/repro_torch/kernels/flash_attention/csrc/
flash_attention.cu`` by replacing one part of the source each, compiled with
the package's own ``nvcc`` flags into ``build/probe/``:

- ``kernel``: the source as it is;
- ``cta_per_tile``: one CTA per work tile instead of one per SM (the same
  code, launched on a grid of every work tile);
- ``two_stages``: a K/V ring of two stages instead of three;
- ``no_wgmma``, ``no_exp2``, ``k_only``: timing only, with wrong results on
  purpose: without any tensor-core product, without the exp2 of the softmax
  (p is the exponent itself), and loading only K (half the K/V bytes).

The first three are held to the plain version (``flash_attention_ref``)
within atol = rtol = 1e-2. Each variant is then timed with CUDA events at
llama3.2-1b's prefill shape, hymba-1.5b's two and a head dim of 128, in
turns (all variants, then all again in reverse order), and the lower of
its two times is printed. The last line is one JSON object of the times in
ms, with the card's name and power limit as ``nvidia-smi`` gives them.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

SOURCE = ROOT / "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu"
OUT = ROOT / "build" / "probe"
#: (label, q heads, kv heads, head dim, window) at batch 4, 2048 tokens, causal
SHAPES = [("llama", 32, 8, 64, None), ("hymba window 1024", 25, 5, 64, 1024),
          ("hymba global", 25, 5, 64, None), ("hd128", 32, 8, 128, None)]
#: each variant: (source text, its replacement), all of which must be found
EDITS = {
    "kernel": [],
    "cta_per_tile": [("const int grid = n_work < sms ? (int)n_work : sms;",
                      "const int grid = (int)n_work;")],
    "two_stages": [("constexpr int kStages = 3;", "constexpr int kStages = 2;")],
    "no_wgmma": [("          wgmma_rs_n64(oacc[hh], pa[t],", "          if (0) wgmma_rs_n64(oacc[hh], pa[t],"),
                 ("        if constexpr (T::BK == 128)\n          wgmma_ss_n128(sacc, da, db, t > 0);\n"
                  "        else\n          wgmma_ss_n64(sacc, da, db, t > 0);",
                  "        (void)da, (void)db;")],
    "no_exp2": [("p[e] = ex2(fmaf(", "p[e] = (fmaf(")],
    "k_only": [("          tma_load_4d(sv + off, &tv, full0 + 8 * s, hh * 64, kh, k0, wk.b);\n", ""),
               ("mbar_expect_tx(full0 + 8 * s, 2 * T::KV_BYTES);",
                "mbar_expect_tx(full0 + 8 * s, T::KV_BYTES);")],
}
CHECKED = ("kernel", "cta_per_tile", "two_stages")


def build(backend) -> dict:
    """One library per variant, all nvcc runs started together."""
    src = SOURCE.read_text()
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, edits in EDITS.items():
        text = src
        for old, new in edits:
            if old not in text:
                sys.exit(f"flash_probe: {name}: the source no longer has {old!r}")
            text = text.replace(old, new)
        cu = OUT / f"{name}.cu"
        cu.write_text(text)
        procs[name] = subprocess.Popen(
            [backend.nvcc_path(), *backend.NVCC_FLAGS, "-o", str(OUT / f"lib{name}.so"), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            sys.exit(f"flash_probe: {name} did not build:\n{log[-2000:]}")
        lib = ctypes.CDLL(str(OUT / f"lib{name}.so"))
        lib.repro_flash_attention.restype = ctypes.c_int
        libs[name] = lib
    return libs


def main() -> int:
    import torch

    from repro_torch import backend
    from repro_torch.kernels.flash_attention import flash_attention as fa

    if not torch.cuda.is_available():
        print("flash_probe: no CUDA device", file=sys.stderr)
        return 2
    smi = backend.nvidia_smi()
    print(f"card: {smi}")
    libs = build(backend)
    for lib in libs.values():
        lib.repro_flash_attention.argtypes = fa._ARGTYPES

    def timed(fn, n=50):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(n):
            fn()
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / n

    gen = torch.Generator(device="cuda").manual_seed(0)
    results = {}
    for label, H, KH, hd, window in SHAPES:
        q, k, v = (torch.randn(4, 2048, n, hd, generator=gen, device="cuda").bfloat16()
                   for n in (H, KH, KH))
        strides = [s for t in (q, k, v) for s in fa.tma_strides(t)]

        def call(lib):
            out = torch.empty_like(q)
            err = lib.repro_flash_attention(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), 1, 4, 2048, 2048, H, KH,
                hd, *strides, 1, int(window is not None), window or 0, hd**-0.5,
                torch.cuda.current_stream().cuda_stream)
            if err:
                sys.exit(f"flash_probe: launch failed with cudaError_t {err}")
            return out

        want = fa.flash_attention_ref(q, k, v, causal=True, window=window).float()
        for name in CHECKED:
            torch.testing.assert_close(call(libs[name]).float(), want, atol=1e-2, rtol=1e-2)
        times = {name: [] for name in libs}
        for name in list(libs) + list(libs)[::-1]:
            times[name].append(timed(lambda: call(libs[name])))
        results[label] = {name: min(t) for name, t in times.items()}
        print(f"{label}: q {tuple(q.shape)}, k/v {KH} heads, window {window}: " + ", ".join(
            f"{name} {ms:.4f} ms" for name, ms in results[label].items()), flush=True)
    print(json.dumps({"card": smi, "ms": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
