#!/usr/bin/env python3
"""Where the WAN window of ``tests/test_torch_serving_planes.py``'s gateway
scenario waits, on the CPU, with the host idle or loaded.

Runs ``gateway_run`` once in a fresh process per package (the reference's
first decode of a shape compiles, so only a fresh process shows it), with
``ReliableChannel`` instrumented: the longest handler call in the gateway's
thread (the time from a frame's arrival to its ack) and the retransmits of
each window. ``--load N`` starts N busy processes first; ``--warm`` decodes
the scenario's float runs once through the reference's wire before it, as
the test does. The sender gives up after 8 rounds of 30 ms without an ack.

    python3 scripts/gateway_stall_probe.py --load 14 --runs 3
    python3 scripts/gateway_stall_probe.py --load 14 --runs 3 --warm
"""
from __future__ import annotations

import argparse
import json
import multiprocessing as mp
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

CHILD = r"""
import json, sys, time
sys.path[:0] = [{src!r}, {tests!r}]
import test_torch_serving_planes as T
pkg = {pkg!r}
if pkg == "ref":
    from types import SimpleNamespace
    import repro.comm.chunnels as chunnels
    import repro.core as core
    import repro.serving.gateway as gateway
    from repro.core import fabric as F
    P = SimpleNamespace(core=core,
        gateway=lambda fabric, addr: gateway.WanGateway(fabric, addr, use_kernel=False),
        wanlink=lambda ep, peer, **kw: chunnels.WanLinkChunnel(ep, peer, use_kernel=False, **kw))
else:
    from repro_torch.core import fabric as F
    P = T.PORT
if {warm!r}:
    T.warm_reference_decode()
handler_ms, retransmits = [], []
serve, window = F.ReliableChannel.serve_one, F.ReliableChannel.request_window
def timed_serve(self, handler, timeout=None):
    def h(src, body):
        t = time.monotonic()
        try:
            return handler(src, body)
        finally:
            handler_ms.append((time.monotonic() - t) * 1e3)
    return serve(self, h, timeout=timeout)
def counted_window(self, msgs, **kw):
    r0 = self.retransmits
    try:
        return window(self, msgs, **kw)
    finally:
        retransmits.append(self.retransmits - r0)
F.ReliableChannel.serve_one, F.ReliableChannel.request_window = timed_serve, counted_window
try:
    T.gateway_run(P)
    ok = True
except TimeoutError:
    ok = False
print(json.dumps({{"ok": ok, "max_handler_ms": max(handler_ms),
                  "window_retransmits": retransmits}}))
"""


def _busy() -> None:
    while True:
        pass


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--load", type=int, default=0, help="busy processes started first")
    ap.add_argument("--runs", type=int, default=3, help="fresh processes per package")
    ap.add_argument("--warm", action="store_true", help="warm the reference's decode first")
    args = ap.parse_args()
    ctx = mp.get_context("spawn")
    busy = [ctx.Process(target=_busy, daemon=True) for _ in range(args.load)]
    for p in busy:
        p.start()
    try:
        time.sleep(2.0 if busy else 0.0)
        for pkg in ("ref", "port"):
            for _ in range(args.runs):
                code = CHILD.format(src=str(ROOT / "src"), tests=str(ROOT / "tests"), pkg=pkg,
                                    warm=args.warm)
                out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                                     text=True, timeout=300,
                                     env={"JAX_PLATFORMS": "cpu", "PATH": "/usr/bin:/bin"})
                rec = json.loads(out.stdout.strip().splitlines()[-1]) if out.returncode == 0 \
                    else {"error": out.stderr[-500:]}
                print(json.dumps({"package": pkg, "load": args.load, "warm": args.warm, **rec}))
    finally:
        for p in busy:
            p.kill()


if __name__ == "__main__":
    main()
