"""The readings that a cell's limits are set from (``limits/<workload>.json``):
on each seed, the program's compared numbers after a short window at the
cell's own load and sizes, and those of the control (the reference computed
in fp8 in the program's place) and of the planted faults, in one process.

  python3 portbench/calibrate.py --workload phi3v-prefill-mix \\
      --seeds 11,12,13 --seconds 2 --produce program,fp8 --out cal.jsonl

Each reading is one JSON line on standard output (and appended to ``--out``).
The benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from types import SimpleNamespace

from run import script_env


def main(argv=None) -> int:
    script_env()
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--produce", default="program,fp8")
    ap.add_argument("--controls", type=int, default=None,
                    help="produce the controls and faults on the first N seeds only")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import gc

    import torch

    from portbench import spec
    from portbench.reference.common import no_tf32

    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    cell = spec.Cell(spec.benchmark(), args.workload)
    dev = torch.device("cuda", 0)
    driver = cell.driver()
    for n, seed in enumerate(int(s) for s in args.seeds.split(",")):
        t0 = time.time()
        ctx = SimpleNamespace(cfg=cell.cfg, traffic=cell.traffic, seed=seed, device=dev,
                              hooks=None, reference=cell.reference(), smoke=False)
        session = driver.setup(ctx)
        win = session.window(args.seconds)
        session.release()
        no_tf32()
        produces = args.produce.split(",")
        if args.controls is not None and n >= args.controls:
            produces = produces[:1]
        for produce in produces:
            t1 = time.time()
            line = json.dumps({"workload": args.workload, "seed": seed, "produce": produce,
                               "units": len(win["spans"]), "readings": session.readings(produce),
                               "seconds": time.time() - t1, "setup_and_window": t1 - t0})
            print(line, flush=True)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(line + "\n")
        del session
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
