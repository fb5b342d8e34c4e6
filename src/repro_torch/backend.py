"""Device choice, the environment report, and the build of the CUDA kernels.

Entry points that touch tensors take ``device=`` and default to ``"cuda"``;
:func:`resolve_device` raises when that default meets a host without a GPU,
so nothing quietly falls back to the CPU. The CPU runs only when the caller
asks for it (the tests pass ``device="cpu"``).

Kernels are CUDA C++ sources under ``repro_torch/kernels/*/csrc/``. They are
compiled with ``nvcc`` for ``sm_90a`` into a shared library with a plain C
interface and loaded with ``ctypes`` — at first use, never at import, so the
package imports on a host that has no ``nvcc``. The library's file name
carries a hash of its flags and of every file in its ``csrc/``, so an edited
source or header is rebuilt.

``python -m repro_torch.backend`` prints the report: torch and CUDA versions,
the device name and capability, the ``nvcc`` path and the card's name and
power limit as ``nvidia-smi`` gives them.
"""
from __future__ import annotations

import ctypes
import hashlib
import json
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional

import torch

PACKAGE_DIR = Path(__file__).resolve().parent
#: compiled kernels land here, inside the checkout (listed in .gitignore)
BUILD_DIR = PACKAGE_DIR.parents[1] / "build" / "kernels"

#: every kernel source of the package, by library name
KERNEL_SOURCES: Dict[str, Path] = {
    "quantize": PACKAGE_DIR / "kernels" / "quantize" / "csrc" / "quantize.cu",
    "flash_attention": PACKAGE_DIR / "kernels" / "flash_attention" / "csrc" / "flash_attention.cu",
    "ssm_scan": PACKAGE_DIR / "kernels" / "ssm_scan" / "csrc" / "ssm_scan.cu",
    "adamw": PACKAGE_DIR / "kernels" / "adamw" / "csrc" / "adamw.cu",
}

#: IEEE division and rounding stay on: no --use_fast_math, -prec-div=false or
#: -ftz=true, because the wire must be byte-identical to the reference's.
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LIBS: Dict[str, ctypes.CDLL] = {}
_LIBS_LOCK = threading.Lock()


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The device an entry point runs on. ``"cuda"`` without a GPU raises."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch versions of the kernels")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}: use 'cuda' or 'cpu'")
    return dev


def nvcc_path() -> Optional[str]:
    home = os.environ.get("CUDA_HOME")
    for cand in (os.path.join(home, "bin", "nvcc") if home else None,
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    return None


def nvidia_smi() -> str:
    """``name, power.limit`` of the card, or ``"not available"``."""
    exe = shutil.which("nvidia-smi")
    if exe is None:
        return "not available"
    try:
        out = subprocess.run(
            [exe, "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return "not available"
    return out.stdout.strip() if out.returncode == 0 else "not available"


def report() -> dict:
    cuda = torch.cuda.is_available()
    return {
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "cuda_available": cuda,
        "device_count": torch.cuda.device_count() if cuda else 0,
        "device_name": torch.cuda.get_device_name(0) if cuda else None,
        "capability": list(torch.cuda.get_device_capability(0)) if cuda else None,
        "nvcc": nvcc_path(),
        "nvidia_smi": nvidia_smi(),
    }


def lib_path(name: str) -> Path:
    """The library's path, named by a hash of the flags and of every file in
    its source's directory, so that an edited header rebuilds it too."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(p for p in KERNEL_SOURCES[name].parent.rglob("*") if p.is_file()):
        h.update(f.name.encode() + b"\0" + f.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build_kernels(names: Optional[List[str]] = None) -> Dict[str, float]:
    """Compile the named kernel libraries (all by default) that are not built
    yet, one ``nvcc`` per source, all started together. Returns the seconds
    each build took (0.0 when the library was already there). ``nvcc``'s
    output, register counts included, is kept beside each library as
    ``<lib>.log``."""
    names = list(KERNEL_SOURCES) if names is None else names
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.monotonic()
    for name in names:
        lib = lib_path(name)
        if lib.exists():
            continue
        if nvcc is None:
            raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        log = open(lib.with_suffix(".log"), "w")
        procs[name] = (subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(KERNEL_SOURCES[name])],
            stdout=log, stderr=subprocess.STDOUT), tmp, lib, log)
    secs = {name: 0.0 for name in names}
    failed = []
    for name, (proc, tmp, lib, log) in procs.items():
        rc = proc.wait()
        log.close()
        secs[name] = time.monotonic() - t0
        if rc != 0:
            failed.append(f"{name}: nvcc exit {rc}, see {lib.with_suffix('.log')}")
            continue
        os.replace(tmp, lib)  # atomic: a concurrent build sees all or nothing
    if failed:
        raise RuntimeError("kernel build failed: " + "; ".join(failed))
    return secs


def load_kernel_library(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, built first if it is missing."""
    with _LIBS_LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build_kernels([name])
            lib = ctypes.CDLL(str(lib_path(name)))
            _LIBS[name] = lib
        return lib


def check_launch(kernel: str, err: int) -> None:
    """Raise on a nonzero ``cudaError_t`` returned by a launch."""
    if err != 0:
        raise RuntimeError(f"{kernel}: CUDA launch failed with cudaError_t {err}")


if __name__ == "__main__":
    print(json.dumps(report(), indent=1))
