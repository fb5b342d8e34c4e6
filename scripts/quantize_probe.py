#!/usr/bin/env python3
"""What bounds the int8 wire kernels' vector route on the GPU.

Run from the root of the repository, on a machine with one Hopper GPU and
``nvcc``:

    python3 scripts/quantize_probe.py

It builds variants of ``src/repro_torch/kernels/quantize/csrc/quantize.cu``
by replacing one part of the source each, compiled with the package's own
``nvcc`` flags into ``build/probe/``:

- ``kernel``: the source as it is;
- ``persistent``: as many CTAs as fit on the card at once, each warp
  striding over tiles, instead of a warp for every tile;
- ``hints``: streaming loads and stores (``__ldcs``/``__stcs``, evict
  first) instead of plain ones;
- ``unroll_1``, ``unroll_8``: one step of rows per warp tile, or 8 float4
  a lane, instead of 4 float4 a lane;
- ``reciprocal``, ``no_scales``: timing only, with wrong results on purpose:
  a multiply by the scale's reciprocal instead of the IEEE division, and
  quantize_pack without its scale stores.

The variants that keep the results are held byte- and bit-equal to the
plain versions (``quantize_pack_ref``/``unpack_dequant_ref``) at every block
the vector route takes. Each variant's vector route, and the scalar route
of ``kernel``, is then timed with CUDA events on the gradient of one
llama3.2-1b decoder layer (60,821,504 float32, 243 MB, beyond the 50 MB L2)
at blocks 64 and 256, in turns (all variants, then all again in reverse
order), and the lower of its two times is printed with its share of the
memory bound. Beside them, as a yardstick of what the card gives the same
mix of reads and writes, PyTorch's own conversion of the layer's floats to
int8 and of its codes to float32 (4 bytes read and 1 written an element, and
the reverse: the kernels' bytes without the scales), each with its share of
its own byte bound. The last line is one JSON object of the times in ms,
with the card's name and power limit as ``nvidia-smi`` gives them.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

SOURCE = ROOT / "src/repro_torch/kernels/quantize/csrc/quantize.cu"
OUT = ROOT / "build" / "probe"
LAYER_NUMEL = 60_821_504
BLOCKS = (64, 256)
#: device-memory rate of an H100 SXM (NVIDIA's H100 data sheet), bytes/s
MEMORY_RATE = 3.35e12
#: the persistent grid that the ``persistent`` variant puts in place of
#: ``grid_for``: as many CTAs as fit on the card at once
PERSISTENT_GRID = """template <class Kernel>
unsigned persistent_grid(Kernel kernel, long long n_tiles) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
  const long long full = (long long)sms * (per_sm > 0 ? per_sm : 1);
  const long long need = (n_tiles + kWarpsPerBlock - 1) / kWarpsPerBlock;
  return (unsigned)(need < full ? need : full);
}

"""
#: each variant: (source text, its replacement), all of which must be found
EDITS = {
    "kernel": [],
    "persistent": [
        ("}  // namespace", PERSISTENT_GRID + "}  // namespace"),
        ("quantize_pack_vec_kernel<B><<<grid_for(n_tiles)",
         "quantize_pack_vec_kernel<B><<<persistent_grid(quantize_pack_vec_kernel<B>, n_tiles)"),
        ("unpack_dequant_vec_kernel<B><<<grid_for(n_tiles)",
         "unpack_dequant_vec_kernel<B><<<persistent_grid(unpack_dequant_vec_kernel<B>, n_tiles)"),
    ],
    "hints": [
        ("? x[row * (BLOCK / 4) + i + k * T::G]", "? __ldcs(x + row * (BLOCK / 4) + i + k * T::G)"),
        ("codes[row * (BLOCK / 4) + i + k * T::G] = pack4(v[u][k], s[u]);",
         "__stcs(codes + row * (BLOCK / 4) + i + k * T::G, pack4(v[u][k], s[u]));"),
        ("s[u] = scales[row];", "s[u] = __ldcs(scales + row);"),
        ("w[u][k] = codes[row * (BLOCK / 4) + i + k * T::G];",
         "w[u][k] = __ldcs(codes + row * (BLOCK / 4) + i + k * T::G);"),
        ("out[row * (BLOCK / 4) + i + k * T::G] = unpack4(w[u][k], s[u]);",
         "__stcs(out + row * (BLOCK / 4) + i + k * T::G, unpack4(w[u][k], s[u]));"),
    ],
    "unroll_1": [("U = V >= 4 ? 1 : 4 / V;", "U = 1;")],
    "unroll_8": [("U = V >= 4 ? 1 : 4 / V;", "U = V >= 8 ? 1 : 8 / V;")],
    "reciprocal": [("rintf(__fdiv_rn(x, s))", "rintf(__fmul_rn(x, __frcp_rn(s)))")],
    "no_scales": [("scales[row0 + lane] = __float_as_uint(mine);", "(void)mine;")],
}
CHECKED = ("kernel", "persistent", "hints", "unroll_1", "unroll_8")
ENTRY = {("quantize_pack", "vector"): "repro_quantize_pack_vec",
         ("unpack_dequant", "vector"): "repro_unpack_dequant_vec",
         ("quantize_pack", "scalar"): "repro_quantize_pack",
         ("unpack_dequant", "scalar"): "repro_unpack_dequant"}


def build(backend) -> dict:
    """One library per variant, all nvcc runs started together; prints the
    vector kernels' ptxas registers and spills of ``kernel``."""
    src = SOURCE.read_text()
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, edits in EDITS.items():
        text = src
        for old, new in edits:
            if old not in text:
                sys.exit(f"quantize_probe: {name}: the source no longer has {old!r}")
            text = text.replace(old, new)
        cu = OUT / f"quantize_{name}.cu"
        cu.write_text(text)
        procs[name] = subprocess.Popen(
            [backend.nvcc_path(), *backend.NVCC_FLAGS, "-o", str(OUT / f"libquantize_{name}.so"),
             str(cu)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            sys.exit(f"quantize_probe: {name} did not build:\n{log[-2000:]}")
        if name == "kernel":
            func = None
            for line in log.splitlines():
                if "Compiling entry function" in line:
                    func = line.split("'")[1]
                elif func and ("Used" in line or "spill" in line):
                    print(f"ptxas {func}: {line.strip()}")
        lib = ctypes.CDLL(str(OUT / f"libquantize_{name}.so"))
        for entry in ENTRY.values():
            fn = getattr(lib, entry)
            fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                           ctypes.c_void_p]
            fn.restype = ctypes.c_int
        libs[name] = lib
    return libs


def main() -> int:
    import torch

    from repro_torch import backend
    from repro_torch.kernels.quantize.quantize import (
        packed_nbytes, quantize_pack_ref, unpack_dequant_ref)

    if not torch.cuda.is_available():
        print("quantize_probe: no CUDA device", file=sys.stderr)
        return 2
    smi = backend.nvidia_smi()
    print(f"card: {smi}")
    libs = build(backend)

    def call(lib, kernel, route, src, dst, n_blocks, block):
        err = getattr(lib, ENTRY[(kernel, route)])(
            src.data_ptr(), dst.data_ptr(), n_blocks, block,
            torch.cuda.current_stream().cuda_stream)
        if err:
            sys.exit(f"quantize_probe: {kernel} {route} failed with cudaError_t {err}")

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
    flat = torch.randn(LAYER_NUMEL, generator=gen, device="cuda") * 1e-3
    # every block of the vector route on 4099 rows (a ragged last tile), and
    # the timed blocks on the whole layer
    cases = [(block, flat[:4099 * block]) for block in (4, 8, 16, 32, 64, 128, 256, 512, 1024)]
    cases += [(block, flat) for block in BLOCKS]
    for block, x in cases:
        x2d = x.view(-1, block)
        n_blocks = x2d.shape[0]
        want = quantize_pack_ref(x2d)
        want_y = unpack_dequant_ref(want, n_blocks, block).view(torch.int32)
        for name in CHECKED:
            packed = torch.empty(packed_nbytes(n_blocks, block), dtype=torch.uint8, device="cuda")
            y = torch.empty(n_blocks * block, device="cuda")
            call(libs[name], "quantize_pack", "vector", x2d, packed, n_blocks, block)
            call(libs[name], "unpack_dequant", "vector", want, y, n_blocks, block)
            torch.cuda.synchronize()
            if not (torch.equal(packed, want) and torch.equal(y.view(torch.int32), want_y)):
                sys.exit(f"quantize_probe: {name} differs from the plain version at block "
                         f"{block}, {n_blocks} rows")
    print(f"checked: {', '.join(CHECKED)} byte- and bit-equal at blocks 4 to 1024")

    results = {}
    for block in BLOCKS:
        x2d = flat.view(-1, block)
        n_blocks = x2d.shape[0]
        packed = torch.empty(packed_nbytes(n_blocks, block), dtype=torch.uint8, device="cuda")
        y = torch.empty(LAYER_NUMEL, device="cuda")
        bound_ms = (4 * LAYER_NUMEL + packed.numel()) / MEMORY_RATE * 1e3
        runs = [(name, "vector") for name in libs] + [("kernel", "scalar")]
        for kernel, src, dst in (("quantize_pack", x2d, packed), ("unpack_dequant", packed, y)):
            times = {run: [] for run in runs}
            for name, route in runs + runs[::-1]:
                times[(name, route)].append(timed(
                    lambda: call(libs[name], kernel, route, src, dst, n_blocks, block)))
            ms = {f"{name} {route}": min(t) for (name, route), t in times.items()}
            results[f"{kernel} b{block}"] = ms
            print(f"{kernel} b{block} (bound {bound_ms:.4f} ms): " + ", ".join(
                f"{run} {t:.4f} ms ({bound_ms / t:.1%})" for run, t in ms.items()), flush=True)
    codes = torch.empty(LAYER_NUMEL, dtype=torch.int8, device="cuda")
    y = torch.empty(LAYER_NUMEL, device="cuda")
    yard_bound_ms = 5 * LAYER_NUMEL / MEMORY_RATE * 1e3
    for label, fn in (("float32 to int8", lambda: codes.copy_(flat)),
                      ("int8 to float32", lambda: y.copy_(codes))):
        t = min(timed(fn), timed(fn))
        results[f"yardstick {label}"] = t
        print(f"yardstick {label} (torch copy_, bound {yard_bound_ms:.4f} ms): {t:.4f} ms "
              f"({yard_bound_ms / t:.1%})", flush=True)
    print(json.dumps({"card": smi, "ms": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
