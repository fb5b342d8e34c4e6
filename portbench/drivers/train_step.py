"""Traffic driver ``train_step``: one rank trains step after step through the
trainer's step function (``train/step.py`` ``make_train_step``), built as
``launch/train.py`` builds it: a ``ReconfigurableTrainer`` on a one-rank
mesh, the mix's transport, AdamW with float32 parameters and moments in the
configuration's declared type. Its parameters are the benchmark's weights.

Batches come from the seed: ``pool`` batches of tokens with their next
tokens as labels (and the vlm family's patches, standard normals rounded to
bfloat16), made on the device and handed to the step as host arrays, as its
feed takes them; step k trains on batch k % pool.

Correctness: set-up builds the one trainer and state that the window then
drives, and runs the first ``setup_steps`` (3) steps through the window's own
call and feed, on rows that all differ. It keeps each step's loss, the first
step's gradient norm before clipping, each leaf's norm of the first gradient
as the optimizer got it (its first moment over 1 - beta1) and each leaf's
change after the three steps (against its initial value, made again from
the seed). After the window the state is freed and the reference follows
the same three steps from the same weights and batches.
"""
from __future__ import annotations

import gc
import math
import time

import torch

from portbench import compare, port
from portbench.reference import adamw as ref_adamw
from portbench.weights import Weights

INPUT_STREAM = 7919
#: leaves whose reference gradient is under this share of the median leaf's
#: move by round-off alone and are left out of the change
QUIET = 1e-3


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def leaf_norms(tensors: dict, scale: float = 1.0) -> dict:
    names = list(tensors)
    norms = torch.stack([tensors[n].float().norm() for n in names]).mul(scale).tolist()
    return dict(zip(names, norms))


class Session:
    def __init__(self, ctx):
        from repro_torch.configs.base import ShapeConfig, ShardingConfig, TrainConfig
        from repro_torch.launch.mesh import make_mesh
        from repro_torch.models import registry
        from repro_torch.optim import adamw
        from repro_torch.train.trainer import HostSpec, ReconfigurableTrainer

        self.ctx, self.cfg, self.tr = ctx, ctx.cfg, ctx.traffic
        self.dev, self.ref = ctx.device, ctx.reference
        B, S = self.tr["batch"], self.tr["seq"]
        self.opt = dict(self.tr["optimizer"], moment_dtype=self.cfg["dtypes"]["moments"])
        t0 = time.perf_counter()
        pc = port.model_config(self.cfg, smoke=ctx.smoke)
        tcfg = TrainConfig(opt_dtype=self.opt["moment_dtype"], **self.tr["optimizer"])
        mesh = make_mesh((1,), ("data",), device=self.dev)
        transport = self.tr["transport"]
        self.trainer = ReconfigurableTrainer(
            pc, ShapeConfig("portbench", S, B, "train"), mesh, tcfg=tcfg,
            sharding=ShardingConfig(), transport=transport,
            hosts=[HostSpec(0, [transport, "xla"])])
        self.state = self.trainer.init_state(ctx.seed)
        sync(self.dev)
        self.phases = {"trainer": time.perf_counter() - t0}
        t0 = time.perf_counter()
        self.specs = self.ref.param_specs(self.cfg)
        Weights(self.specs, ctx.seed, self.dev).fill(self.state.params)

        g = torch.Generator(device=self.dev).manual_seed(ctx.seed * 2 + INPUT_STREAM)
        self.pool = []
        for _ in range(self.tr["pool"]):
            seq = torch.randint(0, self.cfg["vocab_size"], (B, S + 1), generator=g,
                                device=self.dev, dtype=torch.int32)
            batch = {"tokens": seq[:, :-1], "labels": seq[:, 1:]}
            if "patch_positions" in self.cfg:
                batch["patches"] = torch.randn(
                    (B, self.cfg["patch_positions"], self.cfg["patch_dim"]), generator=g,
                    device=self.dev).to(torch.bfloat16).float()
            self.pool.append({k: v.cpu().numpy() for k, v in batch.items()})
        self.tokens_per_step = B * S
        sync(self.dev)
        self.phases["weights and batches"] = time.perf_counter() - t0

        if ctx.hooks is not None:
            h = ctx.hooks
            h.attr(registry, "loss", "forward")
            h.attr(torch.autograd, "backward", "backward")
            h.attr(adamw, "update", "optimizer")

        # the first steps, through the window's own call and feed
        t0 = time.perf_counter()
        self.losses, self.grad_norm = [], None
        for k in range(self.tr["setup_steps"]):
            metrics = self._step()
            if k == 0:
                self.grad_norm = metrics["grad_norm"]
                self.grads = leaf_norms(self.state.opt.m, 1.0 / (1.0 - self.opt["beta1"]))
        self.phases["first steps"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        w0 = Weights(self.specs, ctx.seed, self.dev)
        self.changes = {n: float((self.state.params[n].detach() - p0).norm())
                        for n, p0 in w0.leaves()}
        sync(self.dev)
        self.phases["change norms"] = time.perf_counter() - t0

    def _step(self) -> dict:
        self.state, hist = self.trainer.run(self.state, lambda k: self.pool[k % len(self.pool)],
                                            1)
        metrics = hist[-1]
        if len(self.losses) < self.tr["setup_steps"]:
            self.losses.append(metrics["loss"])
        return metrics

    def _timed(self, spans: list) -> bool:
        t0 = time.perf_counter()
        loss = self._step()["loss"]
        spans.append((t0, time.perf_counter(), self.tokens_per_step))
        return math.isfinite(loss)

    def window(self, seconds: float, capture=None) -> dict:
        spans, stretch, excluded, failed, i = [], None, None, 0, 0
        at = 2 if capture is not None else None
        sync(self.dev)
        t_start = time.perf_counter()
        while True:
            if i == at:
                ta = time.perf_counter()

                def two_steps():
                    nonlocal failed
                    for _ in range(2):
                        failed += not self._timed(spans)
                    return 2

                stretch = capture(two_steps)
                excluded = (ta, time.perf_counter())
                i += 2
            else:
                failed += not self._timed(spans)
                i += 1
            if spans[-1][1] - t_start >= seconds:
                break
        return {"spans": spans, "t_start": t_start, "stretch": stretch, "excluded": excluded,
                "attempted": len(spans), "failed": failed}

    def release(self) -> None:
        self.trainer = self.state = None
        if self.ctx.hooks is not None:
            self.ctx.hooks.restore()
        gc.collect()
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def _reference(self, produce: str) -> dict:
        """The reference's three steps: "fp32" (the reference), "fp8" (the
        control), or "half_batch" (the loss of half the rows, a fault)."""
        w = Weights(self.specs, self.ctx.seed, self.dev).make()
        for p in w.values():
            p.requires_grad_(True)
        precision = "fp8" if produce == "fp8" else "fp32"
        moments, out = {}, {"losses": []}
        for k in range(self.tr["setup_steps"]):
            batch = {n: torch.as_tensor(a).to(self.dev) for n, a in self.pool[k].items()}
            if produce == "half_batch":
                batch = {n: t[: t.shape[0] // 2] for n, t in batch.items()}
            loss = self.ref.loss(w, self.cfg, batch, precision=precision)
            loss.backward()
            loss = loss.detach()
            grads = {n: p.grad for n, p in w.items()}
            norm = ref_adamw.step(w, grads, moments, self.opt, k + 1)
            if k == 0:
                out["grad_norm"], out["grads"] = float(norm), leaf_norms(grads)
            out["losses"].append(loss.item())
            for p in w.values():
                p.grad = None
            del grads, loss
        out["changes"] = {n: float((w[n].detach() - p0).norm())
                          for n, p0 in Weights(self.specs, self.ctx.seed, self.dev).leaves()}
        del w, moments
        gc.collect()
        return out

    def readings(self, produce: str = "program") -> dict:
        """The compared numbers, the program's (``produce="program"``) or
        those of the reference run as ``produce`` in its place."""
        if getattr(self, "_want", None) is None:
            self._want = self._reference("fp32")
        want = self._want
        got = ({"losses": self.losses, "grad_norm": self.grad_norm, "grads": self.grads,
                "changes": self.changes} if produce == "program" else self._reference(produce))
        med = sorted(want["grads"].values())[len(want["grads"]) // 2]
        moving = {n for n, v in want["grads"].items() if v >= QUIET * med}
        return {
            "loss_gap": compare.worst(abs(a - b) / abs(b)
                                      for a, b in zip(got["losses"], want["losses"])),
            "grad_norm_gap": abs(got["grad_norm"] - want["grad_norm"]) / want["grad_norm"],
            "grad_gap": compare.norm_gap(got["grads"], want["grads"]),
            "change_gap": compare.norm_gap(got["changes"], want["changes"], moving),
        }


def setup(ctx) -> Session:
    return Session(ctx)
