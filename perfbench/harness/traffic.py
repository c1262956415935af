"""The one traffic generator: requests and batches from a mix's parameters
and ``--seed``.

Every seed gets the same multiset of sizes, in another order, so that two
seeds ask the system for the same work: a length distribution is cut into
``block`` strata (its quantiles at (j + 1/2) / block), and each block of
``block`` consecutive requests holds one length of every stratum, in an
order drawn from the seed. The seed also draws every token id. A request's
prompt length and its output length are permuted independently.
"""
from __future__ import annotations

from collections import Counter
from statistics import NormalDist
from typing import List, Tuple

import numpy as np

SEED_MASK = (1 << 63) - 1


def rng(seed: int, stream: int) -> np.random.Generator:
    """The numpy generator of ``stream`` for ``seed`` (any integer)."""
    return np.random.default_rng([seed & SEED_MASK, stream])


def torch_seed(seed: int, stream: int) -> int:
    """A torch ``manual_seed`` for ``stream`` of ``seed``, in 63 bits."""
    return (int(rng(seed, stream).integers(0, 1 << 62)) + stream) & SEED_MASK


def strata(dist: dict, n: int) -> List[int]:
    """The ``n`` stratum lengths of a length distribution, at its quantiles
    (j + 1/2) / n, rounded and clipped to [min, max]: ``exponential`` of
    ``mean``, or ``lognormal`` of ``median`` and ``sigma`` (natural log)."""
    law = dist.get("dist", "lognormal")
    if law == "exponential":
        def at(u):
            return -dist["mean"] * float(np.log1p(-u))
    elif law == "lognormal":
        nd = NormalDist()

        def at(u):
            return dist["median"] * float(np.exp(dist["sigma"] * nd.inv_cdf(u)))
    else:
        raise ValueError(f"unknown length distribution {law!r}")
    return [int(min(dist["max"], max(dist["min"], round(at((j + 0.5) / n)))))
            for j in range(n)]


def stratified(dist: dict, count: int, block: int, gen: np.random.Generator
               ) -> np.ndarray:
    """``count`` lengths, each block of ``block`` a permutation of the
    strata."""
    base = np.asarray(strata(dist, block))
    n_blocks = -(-count // block)
    return np.concatenate([gen.permutation(base) for _ in range(n_blocks)])[:count]


def serve_requests(mix: dict, seed: int, vocab: int, count: int
                   ) -> List[Tuple[np.ndarray, int]]:
    """``count`` requests (prompt token ids int32, max_new) of a serving
    mix: ``prompt_tokens`` and ``max_new_tokens`` distributions, stratified
    in blocks of ``block``; token ids uniform over the vocabulary."""
    block = mix["block"]
    plen = stratified(mix["prompt_tokens"], count, block, rng(seed, 1))
    nnew = stratified(mix["max_new_tokens"], count, block, rng(seed, 2))
    tok = rng(seed, 3)
    return [(tok.integers(0, vocab, int(p), dtype=np.int32), int(m))
            for p, m in zip(plen, nnew)]


def check_sample(mix: dict, seed: int, requests) -> List[int]:
    """The requests whose answers are checked against the reference:
    ``check_requests`` indices from ``[check_from, check_from +
    check_span)``, drawn from the seed, with the longest request of that
    range (prompt and output together) among them. Only a request that no
    other of the list repeats (prompt and output length) is drawn, so that
    its answer is told apart from any other's."""
    lo, span, n = mix["check_from"], mix["check_span"], mix["check_requests"]
    seen = Counter((p.tobytes(), m) for p, m in requests)
    idx = [i for i in range(lo, lo + span)
           if seen[requests[i][0].tobytes(), requests[i][1]] == 1]
    longest = max(idx, key=lambda i: (len(requests[i][0]) + requests[i][1], -i))
    rest = [i for i in idx if i != longest]
    picked = rng(seed, 4).choice(len(rest), size=n - 1, replace=False)
    return sorted([longest] + [rest[int(i)] for i in picked])


def train_tokens(mix: dict, seed: int, vocab: int, n_batches: int):
    """``n_batches`` global batches of token ids (int64, (B, S) each) as
    one numpy array (n_batches, B, S), uniform over the vocabulary; no
    two rows equal."""
    g = rng(seed, 5)
    B, S = mix["global_batch"], mix["seq_len"]
    return g.integers(0, vocab, (n_batches, B, S), dtype=np.int64)
