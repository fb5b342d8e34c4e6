"""The window's arithmetic (CPU): a rate over all the work and time, and a
tail over every request, each moved by an injected stall."""
import pytest

from portbench import window
from portbench.view import Run


def spans(durations, start=0.0, work=100):
    out, t = [], start
    for d in durations:
        out.append((t, t + d, work))
        t += d
    return out


def test_rate_counts_all_work_over_all_time():
    s = spans([0.1] * 10)
    run = Run({}, {}, {"spans": s, "t_start": 0.0})
    assert run.window_s == pytest.approx(1.0)
    assert window.rate(1000, run.window_s) == pytest.approx(1000.0)


def test_a_stall_moves_the_rate_and_the_tail():
    steady = spans([0.1] * 40)
    stalled = spans([0.1] * 37 + [0.5, 0.5, 0.5])
    tail = lambda s: window.nearest_rank([b - a for a, b, _ in s], 0.95)  # noqa: E731
    rate = lambda s: window.rate(sum(w for *_, w in s), Run(  # noqa: E731
        {}, {}, {"spans": s, "t_start": 0.0}).window_s)
    assert tail(stalled) == pytest.approx(0.5)
    assert tail(steady) == pytest.approx(0.1)
    assert rate(stalled) < rate(steady)


def test_one_stall_beyond_the_p95_does_not_move_it_but_moves_the_rate():
    stalled = spans([0.1] * 39 + [2.0])
    assert window.nearest_rank([b - a for a, b, _ in stalled], 0.95) == pytest.approx(0.1)
    assert window.rate(4000, stalled[-1][1]) < window.rate(4000, 4.0)


def test_nearest_rank_is_a_value_that_occurred():
    vals = [5.0, 1.0, 3.0, 2.0, 4.0]
    assert window.nearest_rank(vals, 0.95) == 5.0
    assert window.nearest_rank(vals, 0.5) == 3.0
    assert window.nearest_rank(list(range(1, 101)), 0.95) == 95
    with pytest.raises(ValueError):
        window.nearest_rank([], 0.95)


def test_the_profiled_stretch_is_left_out_of_the_steady_time():
    s = spans([0.1] * 10)
    run = Run({}, {}, {"spans": s, "t_start": 0.0, "excluded": (0.3, 0.65)})
    assert [x[0] for x in run.steady_spans] == pytest.approx([0.0, 0.1, 0.2, 0.6, 0.7, 0.8, 0.9])
    assert run.steady_s == pytest.approx(0.65)
