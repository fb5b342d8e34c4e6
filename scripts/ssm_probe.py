#!/usr/bin/env python3
"""What the fused selective scan costs on the GPU, and the designs beside it.

Run from the root of the repository, on a machine with one Hopper GPU and
``nvcc``:

    python3 scripts/ssm_probe.py             # the kernel as it is
    python3 scripts/ssm_probe.py --variants  # edited copies of its source

The kernel ``selective_scan`` (``src/repro_torch/kernels/ssm_scan/csrc/
ssm_scan.cu``) gives each channel G threads (``kGroup``), N / G states each,
32 channels a block (``kChannels``), with its registers capped so that an SM
holds 4 blocks (``kMinBlocks``). The first form builds the package's
library, prints ptxas' registers and spills of each instantiation, holds the
kernel to its plain version (``selective_scan_ref``) with ``torch.equal`` on
y and h_last at hymba-1.5b's serving shapes, the prefill (batch 4, 2048
steps, d_in 3200, N 16, B and C bf16 views of an x_proj-like output), a
rank's channels on model 2 (d_in 1600, B and C float32), a decode step
(S = 1 from a carried state) and S = 300, and times the first three with
CUDA events.

``--variants`` builds copies of the source with one part replaced, each
with the package's ``nvcc`` flags into ``build/probe/`` (N 16 only), holds
each (but ``fast_exp``) to the plain version at the rank's channels, and
times each at the prefill and the rank's channels, in turns (every
variant, then every variant in reverse order), printing the lower of its
two times: ``kernel`` as it is; ``g1`` and ``g2`` (1 and 2 threads a
channel); ``uncapped`` (no register cap); ``warp`` (one warp a block: 8
channels); ``fast_exp`` (``__expf``: other bits, timing only). It writes
``cuobjdump -sass`` of each variant's library under ``build/probe/``.

The last line is one JSON object of the times in ms, with the card's name
and power limit as ``nvidia-smi`` gives them.
"""
from __future__ import annotations

import ctypes
import json
import re
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

#: (label, batch, steps, d_in, B/C dtype, h0 scale); N 16, dt_rank 100
CASES = [("prefill", 4, 2048, 3200, "bfloat16", 0.0),
         ("rank channels", 4, 2048, 1600, "float32", 0.0),
         ("decode", 4, 1, 3200, "bfloat16", 0.1),
         ("S 300", 4, 300, 3200, "bfloat16", 0.1)]
N, RANK = 16, 100
TIMED = ("prefill", "rank channels", "decode")
SOURCE = ROOT / "src/repro_torch/kernels/ssm_scan/csrc/ssm_scan.cu"
OUT = ROOT / "build" / "probe"
#: each variant: (source text, its replacement), all of which must be found
N16_ONLY = [("    case 4: return launch<TBC, 4>(p, stream);\n", ""),
            ("    case 8: return launch<TBC, 8>(p, stream);\n", "")]
GROUP = "constexpr int kGroup = 4;"
VARIANTS = {"kernel": [],
            "g1": [(GROUP, "constexpr int kGroup = 1;")],
            "g2": [(GROUP, "constexpr int kGroup = 2;")],
            "uncapped": [("constexpr int kMinBlocks = 4;", "constexpr int kMinBlocks = 1;")],
            "warp": [("constexpr int kChannels = 32;", "constexpr int kChannels = 8;")],
            "fast_exp": [("const float a = expf(", "const float a = __expf(")]}
UNCHECKED = ("fast_exp",)


def scan_inputs(torch, gen, batch, S, d_in, bc_dtype, h0_scale):
    """Inputs as ``ssm_apply`` hands them over: dt = softplus of a normal
    shifted below 0 (0.01 to 0.3 mostly), x = silu of a normal in bf16, B and
    C column views of a (batch, S, dt_rank + 2N) tensor, A = -(1..N) (the
    S4D-real start), h0 normal times ``h0_scale``, D = 1."""
    dev = "cuda"
    dt = torch.nn.functional.softplus(
        torch.randn((batch, S, d_in), generator=gen, device=dev) - 3.0)
    x = torch.nn.functional.silu(
        torch.randn((batch, S, d_in), generator=gen, device=dev)).to(torch.bfloat16)
    proj = torch.randn((batch, S, RANK + 2 * N), generator=gen, device=dev).to(
        getattr(torch, bc_dtype))
    Bm, Cm = proj[..., RANK:RANK + N], proj[..., RANK + N:]
    A = -torch.arange(1, N + 1, dtype=torch.float32, device=dev).expand(d_in, N).contiguous()
    h0 = torch.randn((batch, d_in, N), generator=gen, device=dev) * h0_scale
    D = torch.ones(d_in, device=dev)
    return dt, x, Bm, Cm, A, h0, D


def time_ms(torch, fn, reps=11, group=5):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(group):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / group)
    return statistics.median(times)


def ptxas_usage(log: str) -> list:
    """(entry, line) for each selective_scan entry's spills and registers."""
    out, name = [], ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
        elif "selective_scan" in name and ("spill" in line or "Used" in line):
            out.append((name, line.strip()))
    return out


def equal_to_plain(torch, K, args) -> tuple:
    got, want = K.selective_scan(*args), K.selective_scan_ref(*args)
    torch.cuda.synchronize()
    err = max((a - b).abs().max().item() for a, b in zip(got, want))
    return all(torch.equal(a, b) for a, b in zip(got, want)), err


def build_variants(backend) -> dict:
    """Each variant's library, built together; its SASS beside it."""
    OUT.mkdir(parents=True, exist_ok=True)
    text, procs = SOURCE.read_text(), {}
    for name, edits in VARIANTS.items():
        src = text
        for old, new in edits + N16_ONLY:
            if old not in src:
                raise SystemExit(f"variant {name}: {old!r} not in the source")
            src = src.replace(old, new)
        cu = OUT / f"{name}.cu"
        cu.write_text(src)
        lib = OUT / f"lib{name}.so"
        procs[name] = (subprocess.Popen([backend.nvcc_path(), *backend.NVCC_FLAGS, "-o",
                                         str(lib), str(cu)], stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True), lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"variant {name}: nvcc failed\n{out}")
        for entry, line in ptxas_usage(out):
            if "bfloat16" in entry:
                print(f"variant {name}: ptxas (B, C bf16): {line}")
        sass = subprocess.run(["/usr/local/cuda/bin/cuobjdump", "-sass", str(lib)],
                              capture_output=True, text=True).stdout
        (OUT / f"{name}.sass").write_text(sass)
        libs[name] = ctypes.CDLL(str(lib))
    return libs


def variants(torch, backend, K) -> int:
    libs = build_variants(backend)
    gen = torch.Generator(device="cuda").manual_seed(0)
    inputs = {label: scan_inputs(torch, gen, *rest) for label, *rest in CASES
              if label in ("prefill", "rank channels")}
    ok = True
    for name, lib in libs.items():
        fn = lib.repro_selective_scan
        fn.argtypes, fn.restype = K._SCAN_ARGTYPES, ctypes.c_int
        if name not in UNCHECKED:
            K._ENTRIES["repro_selective_scan"] = fn
            equal, err = equal_to_plain(torch, K, inputs["rank channels"])
            ok &= equal
            print(f"variant {name}: bit-equal to the plain version {equal}, max abs err {err}")
    times: dict = {}
    for order in (list(libs), list(reversed(libs))):
        for name in order:
            K._ENTRIES["repro_selective_scan"] = libs[name].repro_selective_scan
            for label, args in inputs.items():
                times.setdefault(name, {}).setdefault(label, []).append(
                    time_ms(torch, lambda: K.selective_scan(*args), reps=5))
    best = {name: {k: min(v) for k, v in by.items()} for name, by in times.items()}
    for name, by in best.items():
        print(f"variant {name}: " + ", ".join(f"{k} {ms:.4f} ms" for k, ms in by.items()))
    print(json.dumps({"card": backend.nvidia_smi(), "variants_ms": best, "bit_equal": ok}))
    return 0 if ok else 1


def main() -> int:
    import torch

    from repro_torch import backend
    from repro_torch.kernels.ssm_scan import ssm_scan as K

    if not torch.cuda.is_available():
        print("ssm_probe: no CUDA device", file=sys.stderr)
        return 2
    if "--variants" in sys.argv[1:]:
        return variants(torch, backend, K)
    smi = backend.nvidia_smi()
    print(f"card: {smi}")
    backend.build_kernels(["ssm_scan"])
    log = backend.lib_path("ssm_scan").with_suffix(".log").read_text()
    for entry, line in ptxas_usage(log):
        print(f"ptxas {entry}: {line}")
    gen = torch.Generator(device="cuda").manual_seed(0)
    inputs = {label: scan_inputs(torch, gen, *rest) for label, *rest in CASES}
    ok = True
    for label, args in inputs.items():
        equal, err = equal_to_plain(torch, K, args)
        ok &= equal
        print(f"check {label} {tuple(args[0].shape)}: bit-equal {equal}, max abs err {err}")
    ms = {label: time_ms(torch, lambda: K.selective_scan(*inputs[label])) for label in TIMED}
    print("time " + ", ".join(f"{label} {t:.4f} ms" for label, t in ms.items()))
    print(json.dumps({"card": smi, "ms": ms, "bit_equal": ok}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
