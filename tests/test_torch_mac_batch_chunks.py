"""``framing.mac_batch`` takes any number of frames: each row-count group is
cut into launches of at most ``mpk_guard.MAX_BATCH_FRAMES`` frames (the
kernel's limit on the card), held bit for bit to the reference's numpy
``repro.core.framing.mac_batch`` with the limit set small."""
import numpy as np
import pytest
import torch

from repro.core import framing as jframing

from repro_torch.core import framing
from repro_torch.kernels import mpk_guard
from repro_torch.kernels import ops


def _payloads(rows, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 2 ** 32, (r, 128), dtype=np.uint64).astype(np.uint32)
            for r in rows]


@pytest.mark.parametrize("limit", [1, 3, 4, 10, mpk_guard.MAX_BATCH_FRAMES])
def test_chunked_groups_equal_the_reference(monkeypatch, limit):
    rows = [1, 1, 2, 1, 2, 1, 1, 3, 1, 1]          # a group of 7 one-row frames
    arrs = _payloads(rows, seed=limit)
    want = [int(m) for m in jframing.mac_batch(arrs, 0xC0FFEE)]
    monkeypatch.setattr(mpk_guard, "MAX_BATCH_FRAMES", limit)
    calls = []
    real = ops.mac_batch
    monkeypatch.setattr(ops, "mac_batch",
                        lambda stack, tag: calls.append(stack.shape[0]) or real(stack, tag))
    got = framing.mac_batch([torch.from_numpy(a.view(np.int32)).view(torch.uint32)
                             for a in arrs], 0xC0FFEE)
    assert got == want
    assert max(calls) <= limit
    assert sum(calls) == len(rows)


def test_limit_is_the_kernel_grid():
    assert mpk_guard.MAX_BATCH_FRAMES == 65535
