"""The traffic made from the seed."""
import numpy as np
import pytest

from perfbench.harness import bench, traffic

SERVE = bench.load_cell("grok-1-314b.serve").traffic
SEEDS = (0, 7, 2**31 + 11, 3 * 2**40 + 5)


@pytest.mark.parametrize("seed", SEEDS)
def test_same_seed_same_requests(seed):
    a = traffic.serve_requests(SERVE, seed, 131072, 256)
    b = traffic.serve_requests(SERVE, seed, 131072, 256)
    assert all(np.array_equal(p, q) and m == n for (p, m), (q, n) in zip(a, b))


def test_seeds_share_the_sizes_not_the_order_or_tokens():
    """Every block of ``block`` requests holds the same lengths whatever the
    seed; the order and the token ids change with it."""
    block = SERVE["block"]
    runs = [traffic.serve_requests(SERVE, s, 131072, 4 * block) for s in SEEDS]
    for r in runs:
        for b in range(4):
            part = r[b * block:(b + 1) * block]
            assert sorted(len(p) for p, _ in part) == sorted(
                traffic.strata(SERVE["prompt_tokens"], block))
            assert sorted(m for _, m in part) == sorted(
                traffic.strata(SERVE["max_new_tokens"], block))
    assert [len(p) for p, _ in runs[0]] != [len(p) for p, _ in runs[1]]
    assert not np.array_equal(runs[0][0][0][:8], runs[1][0][0][:8])


LAWS = {"serve": SERVE["prompt_tokens"],
        "lognormal": {"dist": "lognormal", "median": 64, "sigma": 0.75, "min": 16,
                      "max": 512}}


@pytest.mark.parametrize("law", sorted(LAWS))
def test_strata_follow_the_mix(law):
    """The law's median sits in the middle stratum, every length lies
    within the mix's bounds, and an exponential's strata average to its
    mean."""
    d = LAWS[law]
    s = traffic.strata(d, 64)
    assert s == sorted(s)
    assert min(s) >= d["min"] and max(s) <= d["max"]
    if d["dist"] == "exponential":
        assert s[31] <= round(d["mean"] * np.log(2)) <= s[32]
        assert abs(np.mean(s) / d["mean"] - 1) < 0.02
    else:
        assert s[31] <= d["median"] <= s[32]


def test_check_sample_holds_the_longest():
    reqs = traffic.serve_requests(SERVE, 5, 131072, 1024)
    lo, span = SERVE["check_from"], SERVE["check_span"]
    got = traffic.check_sample(SERVE, 5, reqs)
    longest = max(range(lo, lo + span), key=lambda i: len(reqs[i][0]) + reqs[i][1])
    assert longest in got and len(got) == SERVE["check_requests"] == len(set(got))
    assert all(lo <= i < lo + span for i in got)
    assert got == traffic.check_sample(SERVE, 5, reqs)
    assert got != traffic.check_sample(SERVE, 6, reqs) or len(got) == span


@pytest.mark.parametrize("workload", ["qwen3-14b.train", "qwen3-14b.train-long"])
def test_train_rows_all_differ(workload):
    mix = bench.load_cell(workload).traffic
    toks = traffic.train_tokens(mix, 2**31 + 3, 151936, 4)
    assert toks.shape == (4, mix["global_batch"], mix["seq_len"])
    rows = toks.reshape(-1, mix["seq_len"])
    assert len({r.tobytes() for r in rows}) == rows.shape[0]
    assert np.array_equal(toks, traffic.train_tokens(mix, 2**31 + 3, 151936, 4))
    assert toks.min() >= 0 and toks.max() < 151936


def test_check_sample_skips_a_repeated_request():
    """A request that another repeats (prompt and output length) is never
    drawn: its answer could not be told apart."""
    mix = dict(SERVE, check_from=0, check_span=16, check_requests=15)
    reqs = traffic.serve_requests(mix, 5, 131072, 64)
    reqs[40] = (reqs[3][0].copy(), reqs[3][1])
    got = traffic.check_sample(mix, 5, reqs)
    assert 3 not in got and len(got) == 15
