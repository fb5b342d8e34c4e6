"""Time the compute split's collectives at a llama3.2-1b rank's prefill shapes.

Two gloo ranks share cuda:0 (as ``chip_smoke.py``'s mesh phases do) and time,
each as the median of 7 calls after 2 warm-ups, with the card synchronised
around each call:

- ``sum_partials``: the float32 all-reduce of a row product's partial output
  (2, 2048, 2048), the residual kept whole (the plain "g");
- ``scatter_seq``: the float32 reduce-scatter of the same partial to the
  rank's 1024 positions, rounded to bfloat16 (the sequence-parallel "g");
- ``gather_seq``: the all-gather of the rank's bfloat16 positions
  (2, 1024, 2048) to (2, 2048, 2048) (the sequence-parallel "f");
- the pieces of each: the copy to the host, gloo's own call, the copy back.

Prints one line per measurement and a JSON object of them all, with the
card's name and power limit.

    python3 scripts/seqpar_collective_probe.py
"""
import json
import os
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))

ROWS, S, D, REPS = 2, 2048, 2048, 7


def _time(torch, fn) -> float:
    for _ in range(2):
        fn()
    out = []
    for _ in range(REPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(out)


def rank() -> dict:
    import torch
    import torch.distributed as dist

    from repro_torch.comm import collectives
    from repro_torch.launch.mesh import make_mesh

    torch.cuda.set_device(0)
    mesh = make_mesh((2,), ("model",), device="cuda:0")
    gen = torch.Generator(device="cuda").manual_seed(mesh.rank)
    partial = torch.randn(ROWS, S, D, generator=gen, device="cuda")
    own = torch.randn(ROWS, S // 2, D, generator=gen, device="cuda").to(torch.bfloat16)
    host = partial.cpu()
    out = {
        "sum_partials": _time(torch, lambda: collectives.sum_partials(
            partial, mesh, "model", torch.bfloat16)),
        "scatter_seq": _time(torch, lambda: collectives.scatter_seq(
            partial, mesh, "model", torch.bfloat16)),
        "gather_seq": _time(torch, lambda: collectives.gather_seq(own, mesh, "model")),
        "copy to host f32 (2, 2048, 2048)": _time(torch, lambda: partial.cpu()),
        "copy to card f32 (2, 1024, 2048)": _time(torch, lambda: host[:, :S // 2].to("cuda")),
        "gloo all_reduce f32 (2, 2048, 2048) on the host": _time(
            torch, lambda: dist.all_reduce(host.clone(), group=mesh.group("model"))),
        "gloo ring step: send/recv f32 (2, 1024, 2048) on the host": _time(
            torch, lambda: collectives._exchange(mesh, "model", host[0].clone(),
                                                 torch.empty_like(host[0]))),
        "gloo all_gather bf16 (2, 1024, 2048) on the host": _time(
            torch, lambda: dist.all_gather([torch.empty_like(own.cpu()) for _ in range(2)],
                                           own.cpu(), group=mesh.group("model"))),
    }
    return {"rank": mesh.rank, "ms": out}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("seqpar_collective_probe: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.launch.mesh import spawn

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    ranks = spawn("seqpar_collective_probe:rank", 2, backend="gloo",
                  reason="the ranks share one GPU; NCCL refuses two ranks on one device")
    for r in ranks:
        for name, ms in r["ms"].items():
            print(f"rank {r['rank']}: {name}: {ms:.3f} ms (median of {REPS})")
    print(smi)
    print(json.dumps({"card": smi, "ranks": ranks}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
