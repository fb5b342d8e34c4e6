"""The readers of the program's own spans (``portbench/spans.py`` and the ten
metrics on it), on synthetic Chrome-trace events (CPU), and the program's
ranges in a stretch that ``devtrace.capture`` profiles."""
import ast
import json
import re
from pathlib import Path

import pytest
import torch

from portbench import devtrace, spec, spans
from portbench.hooks import PREFIX, Hooks
from portbench.test_portbench_trace import _events as hooks_only_events
from portbench.view import Run

ROOT = Path(__file__).resolve().parents[1]
NEW = ("norm_ms.prefill", "rope_ms.prefill", "mlp_act_ms.prefill", "kv_cache_ms.prefill",
       "span_idle_ms.prefill", "attn_ms.train", "matmul_ms.train", "cast_ms.train",
       "launches.train", "span_idle_ms.train")


def _trace(ranges, kernels):
    """Events of a stretch of 0-1000 us: ``ranges`` (name, start, end), the
    program's under its prefix unless the name has the hooks', ``kernels``
    (launch, start, end) each with its launch."""
    ev = [{"ph": "X", "cat": "user_annotation", "name": PREFIX + "stretch", "ts": 0,
           "dur": 1000}]
    ev += [{"ph": "X", "cat": "user_annotation",
            "name": n if n.startswith(PREFIX) else spans.PROGRAM + n, "ts": a, "dur": b - a}
           for n, a, b in ranges]
    for corr, (launch, a, b) in enumerate(kernels):
        ev.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": launch,
                   "dur": 1, "args": {"correlation": corr}})
        ev.append({"ph": "X", "cat": "kernel", "name": f"k{corr}", "ts": a, "dur": b - a,
                   "args": {"correlation": corr}})
    return ev


def _prefill_events():
    """Two batches: the first's regions each launch one kernel, then one
    kernel outside every region; the second runs one long kernel."""
    ranges = [("serve.prefill", 0, 100), ("model.norm", 10, 20), ("model.rope", 20, 30),
              ("model.mlp_act", 30, 40), ("model.kv_cache", 40, 45),
              ("serve.prefill", 100, 200)]
    kernels = [(11, 50, 60), (21, 60, 70), (31, 70, 75), (41, 75, 85), (90, 85, 100),
               (105, 110, 190)]
    return _trace(ranges, kernels)


def _train_events():
    """One step: a layer's forward, then its backward, in which the first
    product's backward range holds the layer's recomputation (attention and
    an operation no finer span holds)."""
    ranges = [("train.step", 0, 1000), ("train.forward", 0, 150),
              ("model.remat", 0, 100), ("model.attention", 10, 20),
              ("model.linear.cast", 30, 35), ("model.linear.matmul", 40, 50),
              ("train.backward", 150, 700), ("model.remat.bwd", 200, 600),
              ("model.linear.matmul.bwd", 210, 400), ("model.remat", 220, 300),
              ("model.attention", 230, 240), ("model.attention.bwd", 410, 450),
              ("model.linear.cast.bwd", 460, 470),
              (PREFIX + "forward", 0, 150), (PREFIX + "backward", 150, 700)]  # the hooks'
    kernels = [(11, 100, 110),   # attention, forward
               (31, 110, 115),   # cast
               (41, 115, 135),   # product
               (60, 135, 140),   # the residual add: model.remat
               (231, 300, 310),  # attention, recomputed inside the product's .bwd
               (250, 310, 320),  # recomputed, in no finer span: model.remat
               (350, 400, 440),  # the product's backward
               (420, 440, 460),  # attention's backward
               (465, 460, 462),  # the cast's backward
               (800, 900, 950)]  # the optimizer: in train.step only
    return _trace(ranges, kernels)


def _run(cell, events, units):
    c = spec.Cell(spec.benchmark(), cell)
    st = devtrace.parse(events, units=units)
    run = Run(c.cfg, c.traffic, {"spans": [(0.0, 1.0, 1)], "t_start": 0.0, "stretch": st,
                                 "excluded": (0.0, 1.0)}, Hooks())
    return c, run


def test_prefill_readers():
    cell, run = _run("phi3v-prefill-mix", _prefill_events(), units=2)
    r = {m: cell.reader(m).read(run) for m in NEW if m.endswith(".prefill")}
    assert r["norm_ms.prefill"] == pytest.approx(10e-3 / 2)
    assert r["rope_ms.prefill"] == pytest.approx(10e-3 / 2)
    assert r["mlp_act_ms.prefill"] == pytest.approx(5e-3 / 2)
    assert r["kv_cache_ms.prefill"] == pytest.approx(10e-3 / 2)
    # idle while the host is inside prefill: 0-50 of the first, 100-110 and
    # 190-200 of the second
    assert r["span_idle_ms.prefill"] == pytest.approx((50 + 20) * 1e-3 / 2)


def test_train_readers_split_without_counting_twice():
    cell, run = _run("phi3v-train-4x1024", _train_events(), units=1)
    r = {m: cell.reader(m).read(run) for m in NEW if m.endswith(".train")}
    assert r["attn_ms.train"] == pytest.approx((10 + 10 + 20) * 1e-3)
    assert r["matmul_ms.train"] == pytest.approx((20 + 40) * 1e-3)  # not the recomputation
    assert r["cast_ms.train"] == pytest.approx((5 + 2) * 1e-3)
    assert r["launches.train"] == 10
    busy = 40 + 20 + 62 + 50  # the kernels' union: 100-140, 300-320, 400-462, 900-950
    st = run.stretch
    assert st.busy_s == pytest.approx(busy * 1e-6)
    assert r["span_idle_ms.train"] == pytest.approx((1000 - busy) * 1e-3)
    owned = dict((o.name, owner) for o, owner in spans.owners(st))
    assert owned["k3"] == owned["k5"] == "model.remat" and owned["k9"] is None
    total = sum(r[m] for m in ("attn_ms.train", "matmul_ms.train", "cast_ms.train"))
    fwd_bwd = cell.reader("fwd_bwd_ms.train").read(run)
    assert fwd_bwd == pytest.approx((40 + 20 + 62) * 1e-3) and total <= fwd_bwd


@pytest.mark.parametrize("cell", ["phi3v-prefill-mix", "phi3v-train-4x1024"])
def test_readers_return_nothing_without_the_programs_spans(cell):
    """A program without the spans (the parent of the change that added
    them) leaves only the hooks' ranges: every new reader returns None."""
    c, run = _run(cell, hooks_only_events(), units=2)
    for m in NEW:
        assert c.reader(m).read(run) is None, m


def test_every_new_metric_is_declared_for_its_cell():
    bench = spec.benchmark()
    declared = {m["name"]: m for m in bench["per_layer"]}
    for m in NEW:
        cell = "phi3v-prefill-mix" if m.endswith(".prefill") else "phi3v-train-4x1024"
        assert declared[m]["workloads"] == [cell] and declared[m]["source"] == "device_trace"
        assert m in spec.Cell(bench, cell).metric_readers()


def _program_span_names():
    """Every span name the program opens by a literal: ``spanned("...")``,
    ``span("...")``, ``TRACER.span("...")`` and ``TRACER.begin_span("...")``."""
    pat = re.compile(r'(?:spanned|span)\(\s*"([^"]+)"')  # span( ends TRACER.span(
    names = set()
    for f in (ROOT / "src" / "repro_torch").rglob("*.py"):
        names.update(pat.findall(f.read_text()))
    return names


def _hook_names():
    """The names the drivers give their hooks (``h.attr``/``h.item``'s third
    argument)."""
    names = set()
    for f in (ROOT / "portbench" / "drivers").glob("*.py"):
        for node in ast.walk(ast.parse(f.read_text())):
            if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                    and node.func.attr in ("attr", "item") and len(node.args) >= 3
                    and isinstance(node.args[2], ast.Constant)):
                names.add(node.args[2].value)
    return names


def test_no_program_span_name_is_a_hooks_name():
    program, hooks = _program_span_names(), _hook_names()
    assert {"serve.prefill", "model.norm", "model.attention", "train.step"} <= program
    assert {"prefill", "attention", "forward", "backward", "optimizer"} <= hooks
    assert not program & hooks
    assert "stretch" not in program


@pytest.fixture
def no_sync(monkeypatch):
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: None)


def _stretch_annotations(prof, path):
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    return [e["name"] for e in events if e.get("cat") == "user_annotation"]


@pytest.mark.filterwarnings("ignore:CUDA is not available")
def test_capture_puts_the_program_in_range_mode(no_sync, tmp_path):
    """The profiler that ``capture`` runs is what puts the program's sites
    in range mode: their ranges, and a region's ``.bwd``, land in the
    stretch's host events, with the program's tracer left off."""
    from repro_torch.obs.ranges import span, spanned
    from repro_torch.obs.trace import TRACER

    double = spanned("model.norm")(lambda x: x * 2)
    x = torch.ones(3, requires_grad=True)

    def fn():
        with span("train.step"):
            double(x).sum().backward()
        return 1

    p = devtrace.capture(fn, None)
    assert not TRACER.enabled and not TRACER.spans()
    names = _stretch_annotations(p.prof, tmp_path / "t.json")
    assert names[0] == PREFIX + "stretch"
    assert sorted(names[1:]) == [spans.PROGRAM + n for n in ("model.norm", "model.norm.bwd",
                                                             "train.step")]


@pytest.mark.filterwarnings("ignore:CUDA is not available")
def test_capture_without_range_mode_leaves_the_tracer_off(no_sync, tmp_path):
    """Outside the profiler the sites open no range: a site called before
    ``capture`` leaves nothing in its stretch, and the tracer stays off."""
    from repro_torch.obs.ranges import spanned
    from repro_torch.obs.trace import TRACER

    out = spanned("model.norm")(lambda x: x * 2)(torch.ones(3, requires_grad=True))
    p = devtrace.capture(lambda: 1, None)
    out.sum().backward()  # after the stretch: no .bwd range in it
    assert not TRACER.enabled
    assert _stretch_annotations(p.prof, tmp_path / "t.json") == [PREFIX + "stretch"]
