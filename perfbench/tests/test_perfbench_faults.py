"""A whole run at the CPU's size, with the timed path broken underneath,
comes out not correct — once for each fault the cell can have, and for an
update without its weight decay or with two leaves' updates swapped — and
the same run unbroken reads far below each fault. (The cells run on one
chip: no exchange between chips to leave out.)"""
import json
from unittest import mock

import pytest
import torch

from perfbench.harness.cell import run_cell
from perfbench.tests.tiny import one_thread, tiny_cell

SEED = 2**31 + 29


def _run(workload, seconds=1.0):
    with one_thread():
        text, checks, _ = run_cell(tiny_cell(workload), SEED, seconds, False,
                                   torch.device("cpu"), 0.0)
    return json.loads(text)["correct"], {k: v["value"] for k, v in checks.items()}


@pytest.fixture(scope="module")
def sound():
    return {w: _run(w) for w in ("grok-1-314b.serve", "qwen3-14b.train")}


def _altered_sample(self, last):
    """Every token altered where it is produced: the runner-up's id in
    place of the argmax's."""
    return last.topk(2, dim=-1).indices[:, 1]


def _state_unchanged_decode(cache, k, v, pos):
    """The decode step returns its cache unchanged: nothing is inserted."""


def test_serve_sound_run_passes(sound):
    ok, got = sound["grok-1-314b.serve"]
    assert ok, got


def test_serve_token_altered_where_produced(sound):
    with mock.patch("repro_torch.runtime.serve.ServingEngine.sample", _altered_sample):
        ok, got = _run("grok-1-314b.serve")
    assert not ok
    assert got["gap_win_clear"] > 10 * max(sound["grok-1-314b.serve"][1]["gap_win_clear"],
                                           1e-3)


def test_serve_step_returns_its_state_unchanged(sound):
    with mock.patch("repro_torch.models.kvcache.dense_cache_insert_rows",
                    _state_unchanged_decode):
        ok, got = _run("grok-1-314b.serve")
    assert not ok
    assert got["err_win_clear"] > 10 * sound["grok-1-314b.serve"][1]["err_win_clear"]


def _no_update(params, grads, state, cfg):
    """The optimizer returns the state as it found it."""
    return params, state, {"lr": 0.0, "grad_norm": torch.zeros(())}


def test_train_step_returns_its_state_unchanged(sound):
    with mock.patch("repro_torch.runtime.steps.adamw_update", _no_update):
        ok, got = _run("qwen3-14b.train")
    assert not ok
    assert got["change_leaf"] == pytest.approx(1.0)


def test_train_half_the_batch_left_out(sound):
    """Each microbatch's loss over its first half only (the mean taken
    over the rest)."""
    from repro_torch.runtime import steps
    real = steps.loss_fn

    def half(cfg, params, mb, **kw):
        return real(cfg, params, {k: v[: v.shape[0] // 2] for k, v in mb.items()}, **kw)

    with mock.patch.object(steps, "loss_fn", half):
        ok, got = _run("qwen3-14b.train")
    assert not ok
    assert got["grad_leaf"] > 10 * sound["qwen3-14b.train"][1]["grad_leaf"]


def test_train_update_without_its_weight_decay(sound):
    """The optimizer leaves out the decay."""
    import dataclasses

    from repro_torch.runtime import steps
    real = steps.adamw_update

    def no_decay(params, grads, state, cfg):
        return real(params, grads, state, dataclasses.replace(cfg, weight_decay=0.0))

    with mock.patch.object(steps, "adamw_update", no_decay):
        ok, got = _run("qwen3-14b.train")
    assert not ok
    assert got["decay_leaf"] > 5 * sound["qwen3-14b.train"][1]["decay_leaf"]
    assert got["decay_leaf"] == pytest.approx(1.0, abs=0.2)


def test_train_key_and_value_updates_swapped(sound):
    """Each of the key and value projections is updated with the other's
    gradient: the norms alike, the directions not."""
    from repro_torch.runtime import steps
    real = steps.adamw_update

    def swapped(params, grads, state, cfg):
        attn = grads["blocks"]["attn"]
        attn["wk"], attn["wv"] = attn["wv"], attn["wk"]
        return real(params, grads, state, cfg)

    with mock.patch.object(steps, "adamw_update", swapped):
        ok, got = _run("qwen3-14b.train")
    assert not ok
    assert got["change_dir"] > 5 * sound["qwen3-14b.train"][1]["change_dir"]
