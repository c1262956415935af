"""The port's Trainer against the reference's: restart equivalence and the
guard-trip recovery (``tests/test_runtime.py``, ported), the heartbeat and
straggler logic, the launcher, and the losses of 8 steps from the same
converted state held to the reference ``Trainer.run(8, state=...)`` on
reduced llama3.2-1b in f32."""
import tempfile

import jax
import numpy as np
import pytest
import torch

from repro.configs import OptimizerConfig as JOptimizerConfig
from repro.configs import TrainConfig as JTrainConfig
from repro.configs import get_reduced as jget_reduced
from repro.models import init_params as jinit_params
from repro.models.transformer import Impl as JImpl
from repro.optim import init_opt_state as jinit_opt_state
from repro.runtime import Trainer as JTrainer

from repro_torch.configs import OptimizerConfig, TrainConfig, get_reduced
from repro_torch.convert import params_from_numpy
from repro_torch.launch import train as train_launcher
from repro_torch.runtime import (FailureInjector, HeartbeatMonitor,
                                 StragglerDetector, Trainer)


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two intra-op threads while this module runs (restored after): the
    suite runs six workers on the same cores, beside timing-sensitive
    gateway tests."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


TCFG = TrainConfig(microbatch_size=2, dtype="float32",
                   optimizer=OptimizerConfig(lr=1e-3, warmup_steps=2, total_steps=50),
                   log_every=0, checkpoint_every=3, keep_checkpoints=2)


def _trainer(cfg, **kw):
    return Trainer(cfg, TCFG, global_batch=4, seq_len=16, device="cpu", **kw)


def test_restart_equivalence():
    """A failed and restarted run ends on the same trajectory as a clean run."""
    cfg = get_reduced("llama3.2-1b")
    with tempfile.TemporaryDirectory() as d:
        tr = _trainer(cfg, checkpoint_dir=d, workers=["w0", "w1"],
                      injector=FailureInjector({5: ["w1"]}))
        rep = tr.run(8)
        assert rep.restarts == 1
        assert any("restarting from last checkpoint" in e for e in rep.events)
    rep2 = _trainer(cfg).run(8)
    assert abs(rep.losses[-1] - rep2.losses[-1]) < 1e-4


def test_guard_trip_recovers_from_checkpoint():
    """A tripped channel guard (corrupted exchange) restores the last
    checkpoint and resumes: the step's in-place update is discarded."""
    cfg = get_reduced("llama3.2-1b")
    with tempfile.TemporaryDirectory() as d:
        tr = _trainer(cfg, checkpoint_dir=d)
        real_fn = tr._fn()
        trip = {"armed": True}

        def wrapped(params, opt, batch):
            p, o, m = real_fn(params, opt, batch)
            m = dict(m)
            if trip["armed"] and len(tr.straggler._times) == 5:
                m["guard_ok"] = 0.0
                trip["armed"] = False
            return p, o, m

        tr._step_fn = wrapped
        rep = tr.run(10)
        assert rep.guard_trips == 1
        assert any("guard tripped" in e for e in rep.events)
        assert rep.steps_run >= 10
    clean = _trainer(cfg).run(10)
    assert abs(rep.losses[-1] - clean.losses[-1]) < 1e-4


def test_resume_from_newest_checkpoint():
    cfg = get_reduced("llama3.2-1b")
    with tempfile.TemporaryDirectory() as d:
        _trainer(cfg, checkpoint_dir=d).run(4)
        rep = _trainer(cfg, checkpoint_dir=d).run(6)
        assert rep.events == ["resumed from checkpoint step 4"]
        assert rep.steps_run == 2
    clean = _trainer(cfg).run(6)
    assert abs(rep.losses[-1] - clean.losses[-1]) < 1e-4


def test_losses_follow_the_reference_trainer():
    """The same converted state, the same synthetic stream: 8 steps of the
    two Trainers give losses within 1e-5 relative (f32; the sums run in
    another order; seen: 1.9e-7)."""
    jcfg, cfg = jget_reduced("llama3.2-1b"), get_reduced("llama3.2-1b")
    jtcfg = JTrainConfig(microbatch_size=2, dtype="float32",
                         optimizer=JOptimizerConfig(lr=1e-3, warmup_steps=2,
                                                    total_steps=50), log_every=0)
    jparams = jinit_params(jcfg, jax.random.PRNGKey(0))
    jstate = {"params": jparams, "opt": jinit_opt_state(jparams)}
    state = params_from_numpy(jax.tree.map(np.asarray, jstate), device="cpu")
    want = JTrainer(jcfg, jtcfg, global_batch=4, seq_len=16,
                    impl=JImpl(attention="chunked", remat=False)).run(8, state=jstate)
    got = _trainer(cfg).run(8, state=state)
    assert got.steps_run == want.steps_run == 8
    np.testing.assert_allclose(got.losses, want.losses, rtol=1e-5)
    assert got.losses[-1] < got.losses[0]


def test_heartbeat_detection():
    mon = HeartbeatMonitor(["a", "b"], timeout=10.0)
    t0 = 1000.0
    mon.beat("a", at=t0)
    mon.beat("b", at=t0)
    assert mon.check(at=t0 + 5) == set()
    mon.beat("a", at=t0 + 11)
    assert mon.check(at=t0 + 12) == {"b"}
    assert mon.alive() == ["a"]


def test_straggler_detector():
    det = StragglerDetector(window=16, factor=2.0)
    assert not any(det.observe(0.1) for _ in range(10))
    assert det.observe(0.5)
    assert not det.observe(0.11)


def test_launcher_trains_the_reduced_model(capsys):
    train_launcher.main(["--device", "cpu", "--steps", "4", "--seq", "16",
                         "--batch", "4", "--micro", "2"])
    out = capsys.readouterr().out
    assert "steps 4" in out and "restarts 0" in out
