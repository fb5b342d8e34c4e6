#!/usr/bin/env python3
"""What AdamW's two kernels a leaf cost on the GPU, against the plain passes.

Run from the root of the repository, on a machine with one Hopper GPU and
``nvcc`` (about 48 GB of device memory):

    python3 scripts/adamw_probe.py

It builds the package's ``adamw`` library and prints ptxas' registers and
spills of each kernel. It lays out phi-3-vision-4.2b's 291 parameter leaves
(3.82 B float32 parameters, the ``phi3v-train-4x1024`` cell's model) with
float32 gradients and bfloat16 moments, and times with CUDA events (median
of groups):

- ``fused``: ``optim.adamw.update`` on those CUDA leaves, the kernel route
  (a ``sumsq`` launch a leaf, one ``norm_scale``, an ``adamw_step`` a leaf);
- ``sumsq`` and ``step``: its two passes alone;
- ``plain``: ``clip_by_global_norm`` and ``_leaf_update`` a leaf, the route
  the update took before the kernels;

each with its GB/s over the bytes it must move (24 a parameter for the
whole update: 4 for the norm, 20 for the step) and its share of the bound
at 3.35 TB/s. It also gives the host's time to enqueue one fused update,
holds ``adamw_step`` to ``g.mul_(scale)`` then ``_leaf_update`` with
``torch.equal`` at four of the cell's leaf shapes (the embedding, a
projection, an MLP weight, a norm scale), and the kernels' norm to
``global_norm`` (relative gap). Nothing of the benchmark runs it.

The last line is one JSON object of the numbers, with the card's name and
power limit as ``nvidia-smi`` gives them.
"""
from __future__ import annotations

import json
import re
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

ARCH = "phi-3-vision-4.2b"
HBM_BYTES_PER_S = 3.35e12
#: the cell's optimizer settings (portbench/traffic/train-4x1024.json)
OPT = dict(learning_rate=3e-4, weight_decay=0.1, beta1=0.9, beta2=0.95, eps=1e-8,
           grad_clip=1.0)


def time_ms(torch, fn, reps: int, group: int) -> float:
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
    """(entry, line) for each kernel's spills and registers."""
    out, name = [], ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
        elif name and ("spill" in line or "Used" in line):
            out.append((name, line.strip()))
    return out


def main() -> int:
    import torch

    from repro_torch import backend
    from repro_torch.configs import get_config
    from repro_torch.configs.base import TrainConfig
    from repro_torch.kernels.adamw import adamw as fused
    from repro_torch.models import registry
    from repro_torch.optim import adamw

    if not torch.cuda.is_available():
        print("adamw_probe: no CUDA device", file=sys.stderr)
        return 2
    smi = backend.nvidia_smi()
    print(f"card: {smi}; torch {torch.__version__}")
    backend.build_kernels(["adamw"])
    for entry, line in ptxas_usage(backend.lib_path("adamw").with_suffix(".log").read_text()):
        print(f"ptxas {entry}: {line}")

    dev = torch.device("cuda")
    shapes = {n: tuple(p.shape) for n, p in
              registry.build(get_config(ARCH), device="meta").named_parameters()}
    n_params = sum(torch.Size(s).numel() for s in shapes.values())
    gen = torch.Generator(device=dev).manual_seed(0)
    params = {n: torch.randn(s, generator=gen, device=dev) * 0.02 for n, s in shapes.items()}
    grads = {k: torch.randn(p.shape, generator=gen, device=dev) * 1e-3
             for k, p in params.items()}
    zeros = lambda: {k: torch.zeros(p.shape, dtype=torch.bfloat16, device=dev)  # noqa: E731
                     for k, p in params.items()}
    state = adamw.AdamWState(zeros(), zeros(), 0)
    cfg = TrainConfig(**OPT)
    lr = OPT["learning_rate"]
    c1, c2 = (float(1 - adamw._f32(b) ** adamw._f32(1)) for b in (cfg.beta1, cfg.beta2))
    print(f"leaves {len(shapes)}, parameters {n_params:,}")

    # bit-equality at the cell's shapes, with the plain route's own scale
    norm = adamw.global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / torch.clamp(norm, min=1e-12), max=1.0)
    equal = {}
    for k in ("embed.table", "layers.0.attn.wq.w", "layers.0.mlp.up.w", "layers.0.ln1.scale"):
        p, g, m, v = (t.clone() for t in (params[k], grads[k], state.m[k], state.v[k]))
        m.copy_(torch.randn(m.shape, generator=gen, device=dev) * 1e-4)
        v.copy_(torch.rand(v.shape, generator=gen, device=dev) * 1e-7)
        want = [t.clone() for t in (p, m, v)]
        adamw._leaf_update(want[0], g.clone().mul_(scale), want[1], want[2], lr, c1, c2, cfg)
        fused.adamw_step(p, g, m, v, scale, lr=lr, c1=c1, c2=c2, beta1=cfg.beta1,
                         beta2=cfg.beta2, eps=cfg.eps, weight_decay=cfg.weight_decay)
        equal[f"{k} {shapes[k]}"] = all(
            torch.equal(a, b) for a, b in zip((p, m, v), want))
        del p, g, m, v, want
    slots = torch.empty(len(shapes), dtype=torch.float32, device=dev)
    for i, g in enumerate(grads.values()):
        fused.sumsq(g, slots[i])
    card_norm = fused.norm_scale(slots, cfg.grad_clip)[0]
    norm_gap = abs(card_norm.item() - norm.item()) / norm.item()
    print(f"bit-equal {equal}; norm {card_norm.item()!r} against {norm.item()!r}: "
          f"relative gap {norm_gap:.3e}")

    def fused_update():
        adamw.update(grads, adamw.AdamWState(state.m, state.v, 0), params, lr, cfg)

    def sumsq_pass():
        for i, g in enumerate(grads.values()):
            fused.sumsq(g, slots[i])
        fused.norm_scale(slots, cfg.grad_clip)

    def step_pass():
        for k in params:
            fused.adamw_step(params[k], grads[k], state.m[k], state.v[k], None, lr=lr, c1=c1,
                             c2=c2, beta1=cfg.beta1, beta2=cfg.beta2, eps=cfg.eps,
                             weight_decay=cfg.weight_decay)

    def plain_update():
        adamw.clip_by_global_norm(grads, cfg.grad_clip)
        for k in params:
            adamw._leaf_update(params[k], grads[k], state.m[k], state.v[k], lr, c1, c2, cfg)

    before = dict(fused.route_leaves)
    fused_update()
    routes = {r: fused.route_leaves[r] - before.get(r, 0) for r in ("kernel", "plain")}
    torch.cuda.synchronize()
    host = []
    for _ in range(5):
        t0 = time.perf_counter()
        fused_update()
        host.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
    ms = {"fused": time_ms(torch, fused_update, 11, 3),
          "sumsq": time_ms(torch, sumsq_pass, 11, 3),
          "step": time_ms(torch, step_pass, 11, 3),
          "plain": time_ms(torch, plain_update, 5, 1)}
    nbytes = {"fused": 24 * n_params, "sumsq": 4 * n_params, "step": 20 * n_params,
              "plain": 24 * n_params}
    result = {"card": smi, "torch": torch.__version__, "leaves": len(shapes),
              "parameters": n_params, "routes": routes, "bit_equal": equal,
              "norm_gap": norm_gap, "host_enqueue_ms": statistics.median(host), "ms": ms,
              "bound_ms": {k: b / HBM_BYTES_PER_S * 1e3 for k, b in nbytes.items()},
              "gb_per_s": {k: nbytes[k] / (ms[k] * 1e-3) / 1e9 for k in ms},
              "share_of_bound": {k: nbytes[k] / HBM_BYTES_PER_S * 1e3 / ms[k] for k in ms}}
    for k in ms:
        print(f"{k}: {ms[k]:.4f} ms, {result['gb_per_s'][k]:.1f} GB/s, "
              f"{100 * result['share_of_bound'][k]:.1f}% of its bound "
              f"{result['bound_ms'][k]:.4f} ms")
    print(f"host enqueue of one fused update: {result['host_enqueue_ms']:.3f} ms; "
          f"routes {routes}")
    print(json.dumps(result))
    ok = all(equal.values()) and routes == {"kernel": len(shapes), "plain": 0}
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
