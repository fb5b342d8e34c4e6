"""Reading a device trace (CPU, synthetic Chrome-trace events): the union of
overlapping device intervals against their sum, attribution of operations to
the benchmark's ranges by their launch, and the per-layer readers."""
import pytest

from portbench import devtrace, spec
from portbench.hooks import Hooks
from portbench.smoke import program_cfg
from portbench.view import Run


def test_union_counts_overlap_once_where_the_sum_counts_it_twice():
    iv = [(0.0, 10.0), (5.0, 15.0), (20.0, 25.0), (21.0, 22.0)]
    assert devtrace.union_seconds(iv) == 20.0
    assert sum(b - a for a, b in iv) == 26.0
    assert devtrace.union_seconds([]) == 0.0
    assert devtrace.gaps(iv, 0.0, 30.0) == [(15.0, 20.0), (25.0, 30.0)]


def _events():
    """A stretch of 100 us: one prefill range holding an ssm range; kernels
    launched inside and outside them; one copy overlapping a kernel."""
    ev = [{"ph": "X", "cat": "user_annotation", "name": "portbench.stretch", "ts": 0, "dur": 100},
          {"ph": "X", "cat": "user_annotation", "name": "portbench.prefill", "ts": 1, "dur": 60},
          {"ph": "X", "cat": "user_annotation", "name": "portbench.ssm", "ts": 10, "dur": 20},
          {"ph": "X", "cat": "user_annotation", "name": "portbench.selective_scan", "ts": 10.5,
           "dur": 1},
          {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 40, "dur": 30}]
    kernels = [(11, 20, 30, "selective_scan_kernel<float, 16>"), (12, 30, 40, "elementwise"),
               (45, 40, 60, "nvjet_gemm"), (80, 82, 90, "late")]
    for corr, (launch, a, b, name) in enumerate(kernels):
        ev.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": launch,
                   "dur": 1, "args": {"correlation": corr}})
        ev.append({"ph": "X", "cat": "kernel", "name": name, "ts": a, "dur": b - a,
                   "args": {"correlation": corr}})
    ev.append({"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 50, "dur": 20,
               "args": {"correlation": 99}})
    return ev


def test_operations_belong_to_the_ranges_open_at_their_launch():
    st = devtrace.parse(_events(), units=2)
    assert st.wall_s == pytest.approx(100e-6)
    assert st.busy_s == pytest.approx((20 + 30 + 8) * 1e-6)  # 20-40, 40-70, 82-90
    assert st.range_device_s("ssm") == pytest.approx(20e-6)
    assert st.range_device_s("prefill") == pytest.approx(40e-6)
    assert st.unattributed() == 1  # the copy has no launch event
    assert st.top_ops(1) == [["nvjet_gemm", pytest.approx(20e-6)]]
    idle = dict(st.idle_gaps())  # 0-20 under ssm (opened at 10), 70-82 and 90-100
    assert idle == {"portbench.ssm": pytest.approx(20e-6),
                    "portbench.stretch": pytest.approx(22e-6)}


def test_a_trace_without_device_operations_is_refused():
    ev = [e for e in _events() if e["cat"] not in devtrace.DEVICE_CATS]
    with pytest.raises(RuntimeError, match="no device operation"):
        devtrace.parse(ev, units=1)


#: readers kept for a hybrid cell (PERF.md, Open questions), read here on
#: the hybrid family's configuration
HYBRID_READERS = ("ssm_ms.prefill", "selective_scan_roofline")


def _run(cell_name, cfg=None):
    cell = spec.Cell(spec.benchmark(), cell_name)
    hooks = Hooks()
    st = devtrace.parse(_events(), units=2)
    return cell, Run(cfg or cell.cfg, cell.traffic,
                     {"spans": [(0.0, 0.5, 4096), (0.5, 1.0, 8192)], "t_start": 0.0,
                      "stretch": st, "excluded": (0.5, 1.0)}, hooks), hooks


def test_every_per_layer_reader_reads_or_returns_nothing():
    for w in spec.benchmark()["workloads"]:
        cell, run, hooks = _run(w["name"])
        for metric, reader in cell.metric_readers().items():
            value = reader.read(run)
            assert value is None or value == value, metric
            if value is not None and metric.endswith(("roofline", "mfu.prefill", "mfu.train")):
                assert 0 < value


def test_the_rooflines_read_the_calls_in_the_stretch():
    cfg = program_cfg("hymba-1.5b", "hymba-1.5b", smoke=False)
    cell, run, hooks = _run("phi3v-prefill-mix", cfg)
    readers = dict(cell.metric_readers(), **{m: cell.reader(m) for m in HYBRID_READERS})
    assert readers["selective_scan_roofline"].read(run) is None  # no call recorded
    hooks.calls["selective_scan"] = [(0.6, 0.7, ((4, 2048, 3200), 16))]
    from portbench.counts import kernels

    least = kernels.least_seconds(*kernels.selective_scan(4, 2048, 3200, 16, cfg["dtypes"]))
    assert readers["selective_scan_roofline"].read(run) == pytest.approx(
        least / 10e-6 * 100)  # the kernel launched inside its range
    assert readers["ssm_ms.prefill"].read(run) == pytest.approx(20e-6 / 2 * 1e3)
    assert readers["flash_attn_roofline.prefill"].read(run) is None
    assert readers["idle_share.prefill"].read(run) == pytest.approx(42.0)
