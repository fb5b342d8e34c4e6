"""Serving launcher: prefill of a batch of prompts, then greedy decode.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b \\
      --batch 4 --prompt-len 2048 --gen 32
  PYTHONPATH=src python -m repro_torch.launch.serve --arch hymba-1.5b \\
      --batch 4 --prompt-len 2048 --gen 32
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-moe-235b-a22b \\
      --layers 3 --batch 4 --prompt-len 2048 --gen 32
  PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu \\
      --batch 2 --prompt-len 32 --gen 4
  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b \\
      --world 4 --data 2 --model 2 --kv-partition sequence \\
      --batch 4 --prompt-len 2048 --gen 32

The counterpart of ``src/repro/launch/serve.py``, for every family. It
serves parameters drawn from seed 0 (the reference serves its random init
from ``PRNGKey(0)``) on ``--device`` (``cuda`` by default, which raises
without a GPU), with attention in prefill by ``--attn-impl`` (``pallas``,
the Hopper flash-attention kernel, by default: every prefill attention of
the dense, moe, vlm, hybrid and audio families); the hybrid family's SSM
layers run the Hopper kernel ``selective_scan``, one launch a layer in
prefill and in each decode step. ``--layers N`` serves the
first N layers of the published config (a cut of depth, for a model whose
weights exceed one card; each stack of the encoder-decoder).

The batch is the reference launcher's, drawn from a ``torch.Generator``
seeded with 0: the prompt tokens, then for vlm the patch embeddings
``patches`` ``(B, P, E)`` and for audio the frame embeddings ``frames``
``(B, max(1, S // src_ratio), E)``, standard normals in bfloat16. After
prefill the model grows its cache by ``gen + 1`` positions as the reference
does: every K/V leaf (the encoder-decoder's cross caches too), only the
global layers' K/V of the hybrid family, nothing of xlstm's state. The last
line printed gives prefill ms, decode ms per token and the first row of
generated tokens.

``--world N`` serves on a mesh of N ranks, one process each
(``serving.steps.serve_sharded``): (pod, data, model) with ``--data`` and
``--model`` ranks on those axes, parameters laid out by the reference's
``param_specs``, the batch's rows dealt over pod and data, the cache's
capacity ``prompt + gen`` rounded up to a multiple of 64, decode through
the KV-partition chunnel ``--kv-partition`` (``auto``: heads where the KV
heads divide ``--model``, else sequence) and the moe family's expert
dispatch ``--moe-dispatch`` (``alltoall`` by default, the config's). These
are the ``ShardingConfig(kv_partition=...)`` and ``moe.dispatch`` that the
reference's dry run sets. Each rank prints its prefill ms, decode ms per
token and the bytes it sent by ``op@axis``.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from dataclasses import dataclass
from typing import List, Optional

import torch

from repro_torch import backend
from repro_torch.configs import ShapeConfig, get_config, get_smoke_config
from repro_torch.models.attention import IMPLS
from repro_torch.models.registry import batch_specs, build

SEED = 0


@dataclass
class ServeResult:
    arch: str
    batch: int
    prompt_len: int
    gen: int
    prefill_s: float
    decode_s: float
    tokens: torch.Tensor  # (B, gen + 1) greedy tokens, the first from prefill
    logits: torch.Tensor  # last decode step's (B, vocab_padded) logits

    @property
    def decode_ms_per_token(self) -> float:
        return self.decode_s / self.gen * 1e3

    @property
    def tokens_per_s(self) -> float:
        """Generated tokens per second of decode, over the batch."""
        return self.batch * self.gen / self.decode_s


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def serve_batch(cfg, batch: int, prompt_len: int, dev: torch.device):
    """The prompt tokens ``(B, S)`` and the family's other prefill inputs
    (``patches`` for vlm, ``frames`` for audio: ``batch_specs``),
    standard normals, from a generator seeded with ``SEED``."""
    specs = batch_specs(cfg, ShapeConfig("serve", prompt_len, batch, "prefill"))
    g = torch.Generator(device=dev).manual_seed(SEED)
    tokens = torch.randint(0, cfg.vocab_size, specs["tokens"][0], generator=g, device=dev)
    extra = {name: torch.randn(shape, generator=g, device=dev).to(dtype)
             for name, (shape, dtype) in specs.items() if name not in ("tokens", "labels")}
    return tokens, extra


def cut_depth(cfg, layers: int):
    """``cfg`` with its first ``layers`` layers (both stacks of an
    encoder-decoder)."""
    if cfg.family == "hybrid":
        raise ValueError("--layers would move the hybrid family's global layers; "
                         "run it at full depth")
    if cfg.family == "audio":
        return cfg.replace(num_layers=layers, encdec=dataclasses.replace(
            cfg.encdec, enc_layers=layers, dec_layers=layers))
    return cfg.replace(num_layers=layers)


def serve(model, *, batch: int, prompt_len: int, gen: int) -> ServeResult:
    """Prefill ``batch`` seeded prompts of ``prompt_len`` tokens (with the
    family's seeded patches or frames), then ``gen`` greedy decode steps;
    times on the host clock, each phase ending in a device synchronise."""
    if gen < 1:
        raise ValueError("gen must be at least 1")
    cfg, dev = model.cfg, model.device
    tokens, extra = serve_batch(cfg, batch, prompt_len, dev)
    _sync(dev)
    t0 = time.perf_counter()
    cache, logits = model.prefill(tokens, **extra)
    _sync(dev)
    t_pre = time.perf_counter() - t0

    cache = model.grow_cache(cache, gen + 1)
    toks = logits.argmax(dim=-1, keepdim=True)
    out = [toks]
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(gen):
        cache, logits = model.decode_step(cache, toks)
        toks = logits.argmax(dim=-1, keepdim=True)
        out.append(toks)
    _sync(dev)
    t_dec = time.perf_counter() - t0
    if not bool(torch.isfinite(logits).all()):
        raise RuntimeError("decode produced non-finite logits")
    return ServeResult(cfg.name, batch, prompt_len, gen, t_pre, t_dec,
                       torch.cat(out, dim=1), logits)


def main(argv: Optional[List[str]] = None) -> ServeResult:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--attn-impl", default="pallas", choices=IMPLS)
    ap.add_argument("--layers", type=int, default=None,
                    help="serve the first N layers (a cut of depth)")
    ap.add_argument("--world", type=int, default=1, help="ranks, one process each")
    ap.add_argument("--threads", type=int, default=None,
                    help="CPU threads of each spawned rank (default: the cores over the world)")
    ap.add_argument("--data", type=int, default=1, help="ranks on the data axis")
    ap.add_argument("--model", type=int, default=1, help="ranks on the model axis")
    ap.add_argument("--kv-partition", default="auto", choices=("auto", "heads", "sequence"))
    ap.add_argument("--moe-dispatch", default=None,
                    choices=("dense", "grouped", "alltoall", "allgather"))
    args = ap.parse_args(argv)
    if args.world > 1:
        return _main_sharded(args)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    cfg = cfg.replace(attn_impl=args.attn_impl)
    if args.layers is not None:
        cfg = cut_depth(cfg, args.layers)
    dev = backend.resolve_device(args.device)
    model = build(cfg, device=dev, seed=SEED)
    res = serve(model, batch=args.batch, prompt_len=args.prompt_len, gen=args.gen)
    print(f"arch={res.arch} attn={cfg.attn_impl} device={dev} "
          f"prefill({res.batch}x{res.prompt_len})={res.prefill_s * 1e3:.0f}ms "
          f"decode={res.decode_ms_per_token:.1f}ms/tok "
          f"first row: {res.tokens[0, :10].tolist()}")
    return res


def _main_sharded(args: argparse.Namespace) -> list:
    from repro_torch.serving.steps import serve_sharded

    ranks = serve_sharded(args.arch, world=args.world, data=args.data, model=args.model,
                          kv_partition=args.kv_partition, moe_dispatch=args.moe_dispatch,
                          smoke=args.smoke, batch=args.batch, prompt_len=args.prompt_len,
                          gen=args.gen, device=args.device, attn_impl=args.attn_impl,
                          layers=args.layers, threads=args.threads)
    for r in ranks:
        run = r["runs"][0]
        print(f"arch={r['arch']} rank {r['rank']} {r['coords']} kv={run['kv']} "
              f"prefill({run['tokens'].shape[0]} rows x {args.prompt_len})="
              f"{run['prefill_s'] * 1e3:.0f}ms decode={run['decode_s'] / args.gen * 1e3:.1f}"
              f"ms/tok sent {run['sent_prefill']} + {run['sent_decode']}")
    print(f"arch={ranks[0]['arch']} world={args.world} first row: "
          f"{ranks[0]['runs'][0]['tokens'][0, :10].tolist()}")
    return ranks


if __name__ == "__main__":
    main()
