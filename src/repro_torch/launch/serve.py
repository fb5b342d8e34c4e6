"""Serving launcher: prefill of a batch of prompts, then greedy decode.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b \\
      --batch 4 --prompt-len 2048 --gen 32
  PYTHONPATH=src python -m repro_torch.launch.serve --arch hymba-1.5b \\
      --batch 4 --prompt-len 2048 --gen 32
  PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu \\
      --batch 2 --prompt-len 32 --gen 4

The counterpart of ``src/repro/launch/serve.py`` for the dense and hybrid
families. It serves parameters drawn from seed 0 (the reference serves its
random init from ``PRNGKey(0)``) on ``--device`` (``cuda`` by default, which
raises without a GPU), with attention in prefill by ``--attn-impl``
(``pallas``, the Hopper flash-attention kernel, by default); the hybrid
family's SSM layers scan with the Hopper SSM-scan kernel. The prompt tokens
come from a ``torch.Generator`` seeded with 0. After prefill the model grows
its cache by ``gen + 1`` positions, as in the reference (the hybrid family
grows only its global layers' K/V). The last line printed gives prefill ms,
decode ms per token and the first row of generated tokens.
"""
from __future__ import annotations

import argparse
import time
from dataclasses import dataclass
from typing import List, Optional

import torch

from repro_torch import backend
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.models.attention import IMPLS
from repro_torch.models.registry import build

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


def serve(model, *, batch: int, prompt_len: int, gen: int) -> ServeResult:
    """Prefill ``batch`` seeded prompts of ``prompt_len`` tokens, then
    ``gen`` greedy decode steps; times on the host clock, each phase ending in
    a device synchronise."""
    if gen < 1:
        raise ValueError("gen must be at least 1")
    cfg, dev = model.cfg, model.device
    g = torch.Generator(device=dev).manual_seed(SEED)
    tokens = torch.randint(0, cfg.vocab_size, (batch, prompt_len), generator=g, device=dev)
    _sync(dev)
    t0 = time.perf_counter()
    cache, logits = model.prefill(tokens)
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
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    cfg = cfg.replace(attn_impl=args.attn_impl)
    dev = backend.resolve_device(args.device)
    model = build(cfg, device=dev, seed=SEED)
    res = serve(model, batch=args.batch, prompt_len=args.prompt_len, gen=args.gen)
    print(f"arch={res.arch} attn={cfg.attn_impl} device={dev} "
          f"prefill({res.batch}x{res.prompt_len})={res.prefill_s * 1e3:.0f}ms "
          f"decode={res.decode_ms_per_token:.1f}ms/tok "
          f"first row: {res.tokens[0, :10].tolist()}")
    return res


if __name__ == "__main__":
    main()
