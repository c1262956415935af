"""The whole-window rate and tail arithmetic."""
import pytest

from perfbench.harness import stats


def test_percentile_is_nearest_rank():
    xs = list(range(1, 101))                    # 1..100
    assert stats.percentile(xs, 95) == 95
    assert stats.percentile(xs, 100) == 100
    assert stats.percentile([5.0], 95) == 5.0
    assert stats.percentile([3, 1, 2], 50) == 2
    assert stats.percentile(list(range(1, 21)), 95) == 19   # ceil(0.95·20) = 19
    with pytest.raises(ValueError):
        stats.percentile([], 95)


def _rec(t0, t1, n, ok=True):
    return {"t_start": t0, "t_end": t1, "n_out": n, "ok": ok}


def test_serve_window_counts_calls_that_end_inside():
    recs = [_rec(0.0, 1.0, 10),                 # ends before the window
            _rec(0.5, 2.0, 20),                 # in
            _rec(1.5, 3.0, 30),                 # in
            _rec(2.0, 3.5, 0, ok=False),        # in, failed
            _rec(3.0, 4.0, 40)]                 # ends at the window's end: out
    w = stats.serve_window(recs, 1.5, 4.0)
    assert w["attempted"] == 3 and w["failed"] == 1 and w["answered"] == 2
    assert w["output_tokens"] == 50
    assert w["output_tokens_per_s"] == pytest.approx(50 / 2.5)
    # latencies 1500 and 1500 ms: a failed call is never a latency
    assert w["request_p95_ms"] == pytest.approx(1500.0)


def test_serve_window_p95_over_all_answered():
    recs = [_rec(0.0, 1.0 + i / 100, 1) for i in range(100)]
    w = stats.serve_window(recs, 1.0, 2.0)
    lat = sorted(1e3 * (1.0 + i / 100) for i in range(100))
    assert w["request_p95_ms"] == pytest.approx(lat[94])


def test_train_rate_runs_to_the_last_steps_end():
    assert stats.train_rate(16384, 45, 10.0, 40.5) == pytest.approx(16384 * 45 / 30.5)
