"""Print the bytes one rank sends, by ``op@axis``, in the mesh paths that
``chip_smoke.py`` runs on the compute split of the moe, audio and ssm
families, as ``analysis.roofline.step_collectives`` counts them (no GPU, no
collective: the count from the layout and the split):

- serving: qwen3-moe-235b-a22b at 1 layer on (data 2, model 2), heads mode,
  under ``alltoall`` and ``allgather``; seamless-m4t-medium on (data 2,
  model 2), heads mode; xlstm-125m at 4 layers on (data 1, model 2). A
  prefill of 4 x 2048 tokens (seamless: over 512 frames) and one decode
  step against a cache of 2112 positions;
- training: qwen3-moe's smoke config on (data 2, model 2), FSDP, a global
  batch of 8 x 64, each mesh dispatch; seamless at its published widths,
  2 + 2 layers, on (data 2, model 2), FSDP, 4 x 128; xlstm-125m at its
  published widths, 2 layers (one mLSTM, one sLSTM), on (data 1, model 2),
  2 x 128;
- the serving working copies a rank makes of each serving path's model
  (``launch.dryrun``'s count on a meta model: a copy the split reads as the
  rank's part at 1/|model|, the moe banks' ``E/|model|`` experts among
  them).

Each line is one rank (rank 0, and the last rank of ``model`` where it
differs) and prints the total and the bytes by ``op@axis`` as JSON.

    PYTHONPATH=src python3 scripts/split_bytes.py
"""
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))

PROMPT, BATCH, CAPACITY = 2048, 4, 2112


def main() -> None:
    from repro_torch.analysis import roofline
    from repro_torch.comm.moe_dispatch import configure
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.configs.base import ShapeConfig, ShardingConfig, TrainConfig
    from repro_torch.launch import dryrun, serve
    from repro_torch.launch.mesh import AbstractMesh
    from repro_torch.models import registry

    moe = serve.cut_depth(get_config("qwen3-moe-235b-a22b"), 1)
    serving = [("qwen3-moe 1 layer alltoall", configure(moe, "alltoall"), (2, 2)),
               ("qwen3-moe 1 layer allgather", configure(moe, "allgather"), (2, 2)),
               ("seamless-m4t-medium", get_config("seamless-m4t-medium"), (2, 2)),
               ("xlstm-125m 4 layers", serve.cut_depth(get_config("xlstm-125m"), 4), (1, 2))]
    for label, cfg, (data, model) in serving:
        for rank in sorted({0, model - 1}):
            mesh = AbstractMesh({"pod": 1, "data": data, "model": model}, rank=rank)
            for kind, S in (("prefill", PROMPT), ("decode", CAPACITY)):
                sent = roofline.step_collectives(cfg, ShapeConfig(kind, S, BATCH, kind), mesh,
                                                 sh=ShardingConfig())
                print(f"serve {label} (data {data}, model {model}) rank {rank} {kind}: "
                      f"{sum(sent.values())} bytes {json.dumps(dict(sorted(sent.items())))}")
        mesh = AbstractMesh({"pod": 1, "data": data, "model": model})
        meta = registry.build(cfg, device="meta")
        print(f"serve {label} (data {data}, model {model}) working copies a rank: "
              f"{dryrun._working_bytes(meta, mesh, ShardingConfig())} bytes (whole: "
              f"{sum(b.numel() * b.element_size() for b in meta.buffers())})")
    tcfg = TrainConfig(warmup_steps=10, total_steps=8)
    fsdp = ShardingConfig(fsdp=True)
    training = [(f"qwen3-moe smoke {impl}", configure(get_smoke_config("qwen3-moe-235b-a22b"),
                                                      impl), ShapeConfig("t", 64, 8, "train"))
                for impl in ("alltoall", "allgather")]
    training.append(("seamless-m4t-medium 2 + 2 layers",
                     serve.cut_depth(get_config("seamless-m4t-medium"), 2),
                     ShapeConfig("t", 128, 4, "train")))
    training = [(label, cfg, shape, (2, 2), fsdp) for label, cfg, shape in training]
    training.append(("xlstm-125m 2 layers", serve.cut_depth(get_config("xlstm-125m"), 2),
                     ShapeConfig("t", 128, 2, "train"), (1, 2), ShardingConfig()))
    for label, cfg, shape, (data, model), sh in training:
        for rank in (0, 1):
            mesh = AbstractMesh({"data": data, "model": model}, rank=rank)
            sent = roofline.step_collectives(cfg, shape, mesh, sh=sh, tcfg=tcfg)
            print(f"train {label} (data {data}, model {model}) rank {rank} a step: "
                  f"{sum(sent.values())} bytes {json.dumps(dict(sorted(sent.items())))}")


if __name__ == "__main__":
    main()
