"""Run one cell of ``BENCHMARK.json`` once, on the machine it is started on.

  python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. The cell's configuration, traffic mix, driver,
limits and metrics are found by name (``spec``). The run builds the program's
kernel libraries where they are missing (into ``build/kernels/`` of the
checkout: a checkout's first run compiles), sets the cell up
(weights and inputs drawn on the device from ``--seed``, every shape of the
mix warmed), measures for ``--seconds``, frees the program's state, compares
what the timed path produced with the family's plain reference, and prints
one JSON line last: the cell's end-to-end metrics with ``--trace 0``, its
per-layer metrics with ``--trace 1`` (a short steady stretch inside the same
window profiled), ``correct``, the build's seconds apart under ``build_s``,
and under ``check`` each compared number with its limit (also the last lines
of standard error). ``setup_s`` runs from the process's start to the first
timed batch or step, the build included.

It exits with an error and prints no result without enough CUDA devices, and
when JAX, its libraries or the JAX package were loaded.
"""
from __future__ import annotations

import time

T_SCRIPT = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def script_env() -> None:
    """The package importable as ``portbench`` beside the program's ``src``;
    caches at fixed paths inside the checkout; no library may load JAX."""
    if sys.path and Path(sys.path[0]).resolve() == HERE:
        sys.path.pop(0)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def process_start() -> float:
    """The wall-clock time this process started (from /proc), or the script's
    first line where /proc is not there."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - (uptime - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return T_SCRIPT


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def card() -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "not available"
    except (OSError, subprocess.TimeoutExpired, IndexError):
        return "not available"


def measure(cell, seed: int, seconds: float, trace: bool, dev, *, smoke: bool = False,
            started: float = None, build_s: float = 0.0) -> tuple:
    """Set the cell up, run its window, compare. Returns (result, lines): the
    result's JSON object and the lines for standard error (the compared
    numbers last). ``smoke`` runs the program's smoke config (the CPU
    tests); ``build_s`` is the part of the set-up that built the kernels."""
    import torch

    from portbench import compare, devtrace
    from portbench.hooks import Hooks
    from portbench.reference.common import no_tf32
    from portbench.view import Run

    cuda = dev.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(dev)) if cuda else (lambda: None)
    hooks = Hooks() if trace else None
    ctx = SimpleNamespace(cfg=cell.cfg, traffic=cell.traffic, seed=seed, device=dev,
                          hooks=hooks, reference=cell.reference(), smoke=smoke)
    t0 = time.time()
    session = cell.driver().setup(ctx)
    sync()
    setup_s = time.time() - (started if started is not None else T_SCRIPT)
    phases = dict(before=t0 - (started if started is not None else T_SCRIPT),
                  **session.phases)
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    capture = (lambda fn: devtrace.capture(fn, dev)) if trace else None
    win = session.window(seconds, capture)
    sync()
    if trace:
        win["stretch"] = win["stretch"].read()
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    run = Run(cell.cfg, cell.traffic, win, hooks)

    metrics = {}
    device = {"platform": "gpu" if cuda else "cpu",
              "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
              "count": cell.chips, "memory_peak_bytes": peak}
    for m in cell.per_layer() if trace else cell.end_to_end():
        if m["name"] == "setup_s":
            value = setup_s
        else:
            value = cell.reader(m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    lines, breakdown = [], None
    if trace:
        st = win["stretch"]
        device.update(busy_s=st.busy_s, window_s=st.wall_s)
        breakdown = {"device_ops": st.top_ops(), "idle_gaps": st.idle_gaps()}
        lines.append(f"portbench: stretch of {st.units} units, {len(st.ops)} device ops "
                     f"({st.unattributed()} without a launch), busy {st.busy_s:.6f} of "
                     f"{st.wall_s:.6f} s")

    session.release()
    no_tf32()
    t0 = time.time()
    readings = session.readings()
    check_s = time.time() - t0
    correct, table, checks = compare.judge(readings, cell.limits)
    result = {"correct": correct, "attempted": win["attempted"], "failed": win["failed"],
              "metrics": metrics, "device": device}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["build_s"] = build_s
    result["check"] = table
    lines.append("portbench: setup phases (s): " + ", ".join(f"{k} {v:.3f}"
                                                             for k, v in phases.items()))
    lines.append(f"portbench: {cell.name} seed {seed}: setup {setup_s:.3f} s, window "
                 f"{run.window_s:.3f} s, {len(run.spans)} units, peak "
                 f"{peak / 2**30:.3f} GiB, check {check_s:.3f} s")
    return result, lines + checks


def main(argv=None) -> int:
    started = process_start()
    script_env()
    args = parse(argv)
    from portbench import spec

    cell = spec.Cell(spec.benchmark(), args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: {args.workload} needs {cell.chips} CUDA device(s), found {n}",
              file=sys.stderr)
        return 2
    from repro_torch import backend

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    t0 = time.time()
    build = backend.build_kernels()
    build_s = time.time() - t0
    result, lines = measure(cell, args.seed, args.seconds, bool(args.trace), dev,
                            started=started, build_s=build_s)
    print(f"portbench: kernel libraries built in {build_s:.3f} s ({build}); card {card()}",
          file=sys.stderr)
    from portbench import guard

    found = guard.loaded()  # what this process loaded, the program's imports included
    if found:
        print(f"portbench: forbidden modules loaded: {found}", file=sys.stderr)
        return 3
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
