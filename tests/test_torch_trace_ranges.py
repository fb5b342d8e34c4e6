"""Range mode (``obs/ranges.py``: the port's sites as ``torch.profiler``
ranges while a profiler records) at the port's layer boundaries, on
phi-3-vision's smoke config on the CPU.

- A profiler puts a range ``repro_torch.<name>`` into the trace for every
  site of a prefill and of a one-rank trainer step; with the tracer also
  enabled, the sites land in its rings too.
- A region's backward lies inside ``<name>.bwd``: every ``MmBackward0`` of
  a ``Linear``'s product inside ``model.linear.matmul.bwd``, every
  ``ToCopyBackward0`` of a weight cast inside ``model.linear.cast.bwd``, the
  chunked attention's backward nodes inside ``model.attention.bwd``; every
  ``.bwd`` range that opens closes.
- Logits, cache, loss and every gradient are bit-equal with range mode on
  and off, under each remat policy.
- With tracing off the sites add no autograd node and leave nothing
  allocated by the tracer; range mode adds the markers alone, the tracer
  without a profiler none.
"""
import collections
import gc
import json
import os
import tracemalloc

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import ShapeConfig, ShardingConfig, TrainConfig
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.layers import mask_padded_vocab
from repro_torch.models.registry import build
from repro_torch.obs import ranges
from repro_torch.obs.trace import TRACER
from repro_torch.train.trainer import HostSpec, ReconfigurableTrainer

ARCH = "phi-3-vision-4.2b"
PREFIX = ranges.PREFIX
B, S = 2, 16


@pytest.fixture(autouse=True)
def tracer_off():
    TRACER.disable()
    TRACER.reset()
    yield
    TRACER.disable()
    TRACER.reset()


def cfg_of(**kw):
    return get_smoke_config(ARCH).replace(attn_impl="xla_chunked", **kw)


def inputs(cfg, seed=0):
    rng = np.random.default_rng(seed)
    seq = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    f = cfg.frontend
    patches = rng.standard_normal((B, f.num_positions, f.embed_dim)).astype(np.float32)
    patches = torch.from_numpy(patches).bfloat16().float().numpy()
    return {"tokens": seq[:, :-1], "labels": seq[:, 1:], "patches": patches}


def as_torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def traced(fn):
    """``fn()`` under the CPU profiler; its result and the trace's events."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    path = os.path.join(os.environ.get("TMPDIR", "/tmp"), f"ranges-{os.getpid()}.json")
    prof.export_chrome_trace(path)
    try:
        with open(path) as f:
            return out, json.load(f)["traceEvents"]
    finally:
        os.remove(path)


def annotations(events):
    return [e for e in events if e.get("cat") == "user_annotation"
            and e["name"].startswith(PREFIX)]


def inside(e, spans):
    return any(s["tid"] == e["tid"] and s["ts"] <= e["ts"]
               and e["ts"] + e["dur"] <= s["ts"] + s["dur"] for s in spans)


@pytest.fixture
def counted_ranges(monkeypatch):
    """Every profiler range range mode opens, and whether it closed."""
    opened = []
    real = ranges.open_range

    class Counted:
        def __init__(self, name):
            self.name, self.rf, self.closed = name, real(name), False
            opened.append(self)

        def __exit__(self, *exc):
            self.closed = True
            return self.rf.__exit__(*exc)

    monkeypatch.setattr(ranges, "open_range", Counted)
    return opened


@pytest.mark.parametrize("impl", ["xla_chunked", "pallas"])
def test_prefill_spans_are_ranges_in_the_trace(counted_ranges, impl):
    cfg = cfg_of().replace(attn_impl=impl)
    model = build(cfg, device="cpu")
    batch = as_torch(inputs(cfg))
    tokens, patches = batch["tokens"].long(), batch["patches"].bfloat16()
    TRACER.enable()
    _, events = traced(lambda: model.prefill(tokens, patches=patches))
    TRACER.disable()
    names = collections.Counter(e["name"][len(PREFIX):] for e in annotations(events))
    L = cfg.num_layers
    want = {"serve.prefill": 1, "model.norm": 2 * L + 1, "model.rope": 2 * L,
            "model.attention": L, "model.mlp_act": L, "model.linear.matmul": 7 * L,
            "model.kv_cache": L + 1}
    assert names == want
    assert all(r.closed for r in counted_ranges) and len(counted_ranges) == sum(names.values())
    # the spans landed in the rings too
    assert len(TRACER.spans("model.norm")) == 2 * L + 1
    assert len(TRACER.spans("model.attention")) == L
    # without a profiler the tracer's spans open no range
    counted_ranges.clear()
    TRACER.enable()
    model.prefill(tokens, patches=patches)
    TRACER.disable()
    assert counted_ranges == [] and len(TRACER.spans("serve.prefill")) == 2


def test_trainer_step_spans_and_backward_ranges(counted_ranges):
    cfg = cfg_of()
    trainer = ReconfigurableTrainer(
        cfg, ShapeConfig("ranges", S, B, "train"), make_mesh((1,), ("data",), device="cpu"),
        tcfg=TrainConfig(), sharding=ShardingConfig(), transport="xla",
        hosts=[HostSpec(0, ["xla"])])
    state = trainer.init_state(0)
    batch = inputs(cfg)
    (state, hist), events = traced(lambda: trainer.run(state, lambda k: batch, 1))
    assert not TRACER.spans()  # the tracer stayed off: the profiler alone
    ann = annotations(events)
    names = collections.Counter(e["name"][len(PREFIX):] for e in ann)
    for name in ("train.step", "train.feed", "train.forward", "train.backward",
                 "train.grad_sync", "train.optimizer", "train.metrics"):
        assert names[name] == 1, name
    L = cfg.num_layers
    # forward and recomputation of each layer, then each region's backward
    assert names["model.remat"] == 2 * L and names["model.remat.bwd"] == L
    assert names["model.linear.matmul"] == 2 * 7 * L
    assert names["model.linear.matmul.bwd"] == 7 * L
    assert names["model.linear.cast.bwd"] == 7 * L + 1  # and the loss head's
    assert names["model.attention.bwd"] == L
    assert names["model.norm.bwd"] == 2 * L + 1

    by = lambda n: [e for e in ann if e["name"] == PREFIX + n]  # noqa: E731
    ops = [e for e in events if e.get("cat") == "cpu_op"]
    mm = [e for e in ops if e["name"] == "MmBackward0" and inside(e, by("model.linear.matmul.bwd"))]
    assert len(mm) == 7 * L
    casts = [e for e in ops if e["name"] == "ToCopyBackward0"
             and inside(e, by("model.linear.cast.bwd"))]
    assert len(casts) == 7 * L + 1
    # xla_chunked's exponentials and batched products run nowhere else
    attn = [e for e in ops if e["name"] in ("ExpBackward0", "BmmBackward0")]
    assert attn and all(inside(e, by("model.attention.bwd")) for e in attn)
    bwd = [r for r in counted_ranges if r.name.endswith(".bwd")]
    assert len(bwd) == sum(v for k, v in names.items() if k.endswith(".bwd"))
    assert all(r.closed for r in counted_ranges)
    assert np.isfinite(hist[-1]["loss"])


def _prefill(ranged: bool):
    cfg = cfg_of()
    model = build(cfg, device="cpu")
    batch = as_torch(inputs(cfg, seed=1))
    run = lambda: model.prefill(batch["tokens"].long(),  # noqa: E731
                                patches=batch["patches"].bfloat16())
    return traced(run)[0] if ranged else run()


def test_prefill_bit_equal_with_ranges():
    (c0, l0), (c1, l1) = _prefill(False), _prefill(True)
    assert torch.equal(l0, l1) and c0["len"] == c1["len"]
    assert torch.equal(c0["k"], c1["k"]) and torch.equal(c0["v"], c1["v"])


def _loss_and_grads(remat: str, mode: str):
    """The loss and every gradient of one backward, tracing ``off``, on
    (``spans``) or in range mode (``ranges``, under a profiler); the
    backward graph's node names."""
    cfg = cfg_of(remat=remat)
    model = build(cfg, device="cpu").release()
    batch = as_torch(inputs(cfg, seed=2))

    def run():
        loss = model.loss(batch)
        nodes, seen, todo = collections.Counter(), set(), [loss.grad_fn]
        while todo:
            n = todo.pop()
            if n is None or n in seen:
                continue
            seen.add(n)
            nodes[type(n).__name__] += 1
            todo.extend(f for f, _ in n.next_functions)
        loss.backward()
        return loss.detach(), nodes

    if mode == "spans":
        TRACER.enable()
    try:
        loss, nodes = traced(run)[0] if mode == "ranges" else run()
    finally:
        TRACER.disable()
    return loss, {n: p.grad for n, p in model.named_parameters()}, nodes


@pytest.mark.parametrize("remat", ["full", "dots", "none"])
def test_loss_and_gradients_bit_equal_with_ranges(remat):
    loss0, g0, nodes0 = _loss_and_grads(remat, "off")
    loss1, g1, nodes1 = _loss_and_grads(remat, "ranges")
    assert torch.equal(loss0, loss1)
    assert g0.keys() == g1.keys() and all(g is not None for g in g0.values())
    for name in g0:
        assert torch.equal(g0[name], g1[name]), name
    # the markers are the only nodes range mode adds; tracing off adds none
    markers = nodes1.pop("_CloseBackward")
    assert markers > 0 and "_CloseBackward" not in nodes0
    assert nodes1 == nodes0
    assert _loss_and_grads(remat, "spans")[2] == nodes0


def test_tracing_off_leaves_nothing_allocated():
    cfg = cfg_of()
    model = build(cfg, device="cpu").release()
    batch = as_torch(inputs(cfg, seed=3))
    files = ("repro_torch/obs/trace.py", "repro_torch/obs/ranges.py")

    def step():
        model.loss(batch).backward()
        model.zero_grad(set_to_none=True)

    def held_by_tracer():
        gc.collect()  # frames a step's checkpoint leaves in reference cycles
        snap = tracemalloc.take_snapshot().filter_traces(
            [tracemalloc.Filter(True, f"*{f}") for f in files])
        return sum(s.size for s in snap.statistics("filename"))

    step()  # imports and first-call caches outside the measurement
    tracemalloc.start()
    try:
        step()
        off = held_by_tracer()
        TRACER.enable()
        step()
        on = held_by_tracer()
    finally:
        TRACER.disable()
        tracemalloc.stop()
    assert off == 0
    assert on > 0  # the same measurement sees the spans an enabled tracer keeps


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mask_padded_vocab_bit_equal_to_where(dtype):
    logits = torch.randn(3, 40, generator=torch.Generator().manual_seed(0)).to(dtype)
    idx = torch.arange(40)
    want = torch.where(idx < 33, logits, torch.tensor(-1e30, dtype=dtype))
    assert torch.equal(mask_padded_vocab(logits, 33), want)
    assert mask_padded_vocab(logits, 40) is logits
