"""Traffic driver ``serve_prefill``: a closed loop of prefill batches, one at a
time, back to back, as the prefill pool of a disaggregated deployment sends
them; the first token of each row comes from prefill's logits (gen 1).

Batch i has ``lengths[i % n]`` positions (the cycle is fixed, not drawn) and
the ``(i // n) % pool``-th of the prompts drawn for that length from the
seed; the vlm family's batches carry seeded patches over their first
positions. The program is driven as ``launch/serve.py`` drives it: the
model of ``registry.model_class`` with the benchmark's weights and its
serving copies made (``prepare``), ``prefill(tokens, **extra)``, the
argmax, the token on the host. Set-up warms each length twice (the
second pass timed, to place the sample and the profiled stretch).

Correctness: before the window the seed picks one cycle among those the
window will certainly finish; the outputs of its batches (one of each
length, the longest among them) are kept as the program returned them: the
last position's logits, the served tokens and the cache (K/V, with the
sliding-window layers' ring layout, and the hybrid family's SSM state and
conv history). After the window the model is freed and the family's
reference runs each kept batch from the same weights and prompts;
``compare_prefill`` compares a batch, with no program needed.

The program's cache, laid out as the reference's in ``as_program``: a window
layer's K/V holds the configuration's M meta tokens whole, then the ring of
the prompt's positions (``ring``); a global layer's all M + S positions in
order; a K/V group's later layer (``kv_groups``) none, or the very tensors
of its group's first layer.
"""
from __future__ import annotations

import random
import time

import torch

from portbench import compare, port
from portbench.reference.common import kv_owners, layer_windows
from portbench.weights import Weights

#: seeds of the prompts and the patches, apart from the weights'
INPUT_STREAM = 7919


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def ring(t: torch.Tensor, S: int, cap: int) -> torch.Tensor:
    """The program's ring layout of a sliding-window layer's K or V (B, S,
    ...): the last ``cap`` positions, slot j holding the position p with
    p % cap == j; the whole prompt where it fits."""
    if S <= cap:
        return t
    return torch.roll(t[:, S - cap:], (S - cap) % cap, dims=1)


def as_program(cfg: dict, out: dict, S: int) -> tuple:
    """A reference's outputs for prompts of S tokens in the program's form:
    (logits, served tokens, cache), as a control or fault put in the
    program's place gives them. A window layer's K/V: the M meta positions
    whole, then ``ring`` of the prompt's positions (capacity min(W, S)); a
    global layer's: all M + S positions in order; a layer without K/V (a
    group's later layer) keeps none."""
    M, windows = cfg.get("meta_tokens", 0), layer_windows(cfg)
    layers = []
    for idx, c in enumerate(out["layers"]):
        if "k" in c:
            cap = S if windows[idx] is None else min(windows[idx], S)
            kv = {n: ring(c[n][:, M:], S, cap) for n in ("k", "v")}
            if M:
                kv = {n: torch.cat([c[n][:, :M], t], dim=1) for n, t in kv.items()}
            c = dict(c, **kv)
        layers.append(c)
    return out["logits"], out["logits"].argmax(-1), {"layers": layers}


def _same(t: torch.Tensor, other) -> bool:
    """Whether ``t`` is the very tensor ``other`` (one storage, offset, shape
    and strides)."""
    return (other is not None and t.untyped_storage().data_ptr()
            == other.untyped_storage().data_ptr() and t.storage_offset()
            == other.storage_offset() and t.shape == other.shape
            and t.stride() == other.stride())


def compare_prefill(cfg: dict, got: tuple, want: dict) -> dict:
    """The compared numbers of one batch: ``got`` = (logits, served tokens,
    cache) as the program returned them, ``want`` the reference's
    ``prefill`` of the same prompts. ``logits_err``: the worst row's relative
    error of the last logits; ``token_gap``: the widest gap below the
    reference's best logit of a served token; ``kv_err``: the worst K or V of
    a layer that owns its K/V, inf where a group's later layer holds any
    other K or V than its owner's very tensors; ``ssm_err`` (hybrid): the
    worst SSM state or conv history."""
    logits, tok, cache = got
    V, M = cfg["vocab_size"], cfg.get("meta_tokens", 0)
    S = want["layers"][0]["k"].shape[1] - M  # layer 0 owns its K/V
    ref, mine = as_program(cfg, want, S)[2]["layers"], _layers(cache)
    out = {"logits_err": compare.worst(
               compare.rel_err(logits[r, :V].float(), want["logits"][r, :V])
               for r in range(want["logits"].shape[0])),
           "token_gap": compare.token_gap(want["logits"][:, :V], tok),
           "kv_err": 0.0 if len(mine) == len(ref) else float("inf")}
    hybrid = cfg["family"] == "hybrid"
    if hybrid:
        out["ssm_err"] = 0.0
    owners = kv_owners(cfg)
    for idx, (m, r) in enumerate(zip(mine, ref)):
        for n in ("k", "v"):
            if n in r:
                err = compare.rel_err(m[n], r[n]) if n in m else float("inf")
            else:
                err = 0.0 if n not in m or _same(m[n], mine[owners[idx]].get(n)) else float("inf")
            out["kv_err"] = compare.worst([out["kv_err"], err])
        if hybrid:
            out["ssm_err"] = compare.worst([out["ssm_err"],
                                            compare.rel_err(m["ssm_h"], r["ssm_h"]),
                                            compare.rel_err(m["ssm_conv"], r["ssm_conv"])])
    return out


class Session:
    def __init__(self, ctx):
        from repro_torch.models import attention, registry, ssm

        self.ctx, self.cfg, self.tr = ctx, ctx.cfg, ctx.traffic
        self.dev = ctx.device
        self.ref = ctx.reference
        t0 = time.perf_counter()
        pc = port.model_config(self.cfg, smoke=ctx.smoke, attn_impl=self.tr["attn_impl"])
        model = registry.model_class(pc)(pc, device=self.dev)
        Weights(self.ref.param_specs(self.cfg), ctx.seed, self.dev).fill(
            dict(model.named_parameters()))
        model.mesh, model.decode_attn_fn = None, None
        self.model = model.prepare()
        sync(self.dev)
        self.phases = {"weights": time.perf_counter() - t0}

        B, self.lengths = self.tr["batch"], list(self.tr["lengths"])
        g = torch.Generator(device=self.dev).manual_seed(ctx.seed * 2 + INPUT_STREAM)
        self.pool = {}
        for L in self.lengths:
            for j in range(self.tr["pool"]):
                tokens = torch.randint(0, self.cfg["vocab_size"], (B, L), generator=g,
                                       device=self.dev)
                extra = {}
                if "patch_positions" in self.cfg:
                    extra["patches"] = torch.randn(
                        (B, self.cfg["patch_positions"], self.cfg["patch_dim"]), generator=g,
                        device=self.dev).to(torch.bfloat16)
                self.pool[L, j] = (tokens, extra)

        if ctx.hooks is not None:
            h = ctx.hooks
            h.attr(self.model, "prefill", "prefill")
            h.attr(attention, "attention", "attention")
            h.attr(attention, "flash_attention", "flash_attention",
                   lambda q, k, v, causal=True, window=None, prefix=0, **kw: (
                       tuple(q.shape), tuple(k.shape), causal, window, prefix))
            if self.cfg["family"] == "hybrid":
                h.attr(ssm, "ssm_apply", "ssm")
                h.item(ssm.SCANS, "pallas", "selective_scan",
                       lambda dt, x, Bm, *a: (tuple(dt.shape), Bm.shape[-1]))

        self.batch_s, t0 = {}, time.perf_counter()
        for _ in range(2):  # warm every shape of the mix, nothing else; time the second
            for L in self.lengths:
                t0 = time.perf_counter()
                self._prefill(self.pool[L, 0])
                sync(self.dev)
                self.batch_s[L] = time.perf_counter() - t0
        self.phases["warm-up"] = time.perf_counter() - t0
        self.kept = {}

    def _prefill(self, inputs):
        tokens, extra = inputs
        cache, logits = self.model.prefill(tokens, **extra)
        return cache, logits, logits.argmax(dim=-1)

    def _batch(self, i: int, spans: list) -> None:
        n = len(self.lengths)
        L = self.lengths[i % n]
        key = (L, (i // n) % self.tr["pool"])
        t0 = time.perf_counter()
        cache, logits, tok = self._prefill(self.pool[key])
        tok.cpu()  # the first token on the host: waits for the device
        t1 = time.perf_counter()
        spans.append((t0, t1, self.tr["batch"] * L))
        if i in self.sample:
            self.kept[i] = (key, logits, tok, cache)

    def window(self, seconds: float, capture=None) -> dict:
        n = len(self.lengths)
        cycle = sum(self.batch_s.values())
        cycles = max(1, int(seconds / cycle / 2))  # cycles the window surely finishes
        first = random.Random(self.ctx.seed).randrange(cycles) * n
        self.sample = set(range(first, first + n))
        at = (cycles // 2) * n if capture is not None else None
        spans, stretch, excluded, i = [], None, None, 0
        sync(self.dev)
        t_start = time.perf_counter()
        while True:
            if i == at:
                ta = time.perf_counter()

                def two_cycles(i=i):
                    for j in range(i, i + 2 * n):
                        self._batch(j, spans)
                    return 2 * n

                stretch = capture(two_cycles)
                excluded = (ta, time.perf_counter())
                i += 2 * n
            else:
                self._batch(i, spans)
                i += 1
            if spans[-1][1] - t_start >= seconds:
                break
        return {"spans": spans, "t_start": t_start, "stretch": stretch, "excluded": excluded,
                "attempted": len(spans) * self.tr["batch"], "failed": 0}

    def release(self) -> None:
        """Free the model; the kept outputs stay."""
        self.model = None
        if self.ctx.hooks is not None:
            self.ctx.hooks.restore()
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def readings(self, produce: str = "program") -> dict:
        """The compared numbers over the kept batches, the program's
        (``produce="program"``) or those of the reference computed in
        ``produce`` (a precision of ``reference.common``) in its place."""
        first = getattr(self, "_want", None) is None
        w = None
        if first or produce != "program":
            w = Weights(self.ref.param_specs(self.cfg), self.ctx.seed, self.dev).make()
        if first:  # the reference, once for every produce
            self._want = {i: self.ref.prefill(w, self.cfg, *self._inputs(i))
                          for i in sorted(self.kept)}
        worst: dict = {}
        for i in sorted(self.kept):
            got = self.kept[i][1:]
            if produce != "program":
                tokens, patches = self._inputs(i)
                got = as_program(self.cfg, self.ref.prefill(
                    w, self.cfg, tokens, patches, precision=produce), tokens.shape[1])
            for name, value in compare_prefill(self.cfg, got, self._want[i]).items():
                worst[name] = compare.worst([worst.get(name, 0.0), value])
            del got
        return worst

    def _inputs(self, i: int) -> tuple:
        """The prompts and patches (or None) of kept batch ``i``."""
        tokens, extra = self.pool[self.kept[i][0]]
        return tokens, extra.get("patches")


def _layers(cache: dict) -> list:
    """Per-layer dicts of a cache, whether the program keeps layers in a list
    (hybrid) or stacks K/V on a leading axis (dense, vlm)."""
    if "layers" in cache:
        return cache["layers"]
    return [{"k": k, "v": v} for k, v in zip(cache["k"], cache["v"])]


def setup(ctx) -> Session:
    return Session(ctx)
