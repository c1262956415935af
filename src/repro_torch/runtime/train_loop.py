"""Training loop: microbatched steps, async checkpointing, restart on
failure, straggler telemetry (the port of ``repro.runtime.train_loop``).

Restart semantics as the reference's: state is (params, opt_state, step)
and data is a pure function of step, so restoring step k reproduces the
trajectory a run without the failure takes. The step function updates the
parameters and moments in place; a result that cannot be trusted (a
tripped channel guard) is therefore recovered from the last checkpoint,
as the reference recovers it.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import List, Optional

import torch

from repro_torch.checkpoint import Checkpointer
from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.data import SyntheticDataset, to_device
from repro_torch.device import resolve
from repro_torch.models import init_params
from repro_torch.models.transformer import Impl
from repro_torch.optim import init_opt_state
from repro_torch.runtime.fault import (FailureInjector, GuardTripError,
                                       HeartbeatMonitor, StragglerDetector)
from repro_torch.runtime.steps import DTYPES, make_train_step
from repro_torch.tree import map_tree


@dataclass
class TrainReport:
    steps_run: int = 0
    restarts: int = 0
    stragglers: int = 0
    guard_trips: int = 0
    losses: List[float] = field(default_factory=list)
    events: List[str] = field(default_factory=list)


class Trainer:
    """The reference's ``Trainer`` on one device. Parameters are drawn in
    ``tcfg.param_dtype`` and AdamW's moments are kept in ``opt_dtype``
    (f32 by default; grok-1-314b's launcher passes bf16, as the
    reference's dry run keeps its training state)."""

    def __init__(self, cfg: ModelConfig, tcfg: TrainConfig, *,
                 global_batch: int, seq_len: int,
                 checkpoint_dir: Optional[str] = None,
                 impl: Impl = Impl(),
                 workers: Optional[List[str]] = None,
                 injector: Optional[FailureInjector] = None,
                 device="cuda", opt_dtype: torch.dtype = torch.float32):
        self.cfg, self.tcfg = cfg, tcfg
        self.opt_dtype = opt_dtype
        self.global_batch, self.seq_len = global_batch, seq_len
        self.impl = impl
        self.device = resolve(device)
        self.dataset = SyntheticDataset(cfg, seq_len, seed=tcfg.seed)
        self.ckpt = (Checkpointer(checkpoint_dir, keep=tcfg.keep_checkpoints)
                     if checkpoint_dir else None)
        self.monitor = HeartbeatMonitor(workers or ["w0"], timeout=1e9)
        self.injector = injector or FailureInjector()
        self.straggler = StragglerDetector()
        self._step_fn = None

    # -- state ------------------------------------------------------------
    def init_state(self, seed: int = 0):
        gen = torch.Generator(device=self.device).manual_seed(seed)
        params = init_params(self.cfg, gen, dtype=DTYPES[self.tcfg.param_dtype])
        return {"params": params, "opt": init_opt_state(params, self.opt_dtype)}

    def _fn(self):
        if self._step_fn is None:
            self._step_fn = make_train_step(self.cfg, self.tcfg, self.impl)
        return self._step_fn

    # -- checkpoint/restart -------------------------------------------------
    def save(self, step: int, state, blocking=False):
        if self.ckpt:
            self.ckpt.save(step, {"params": state["params"], "opt": state["opt"]},
                           blocking=blocking)

    def restore_or_init(self):
        state = self.init_state(self.tcfg.seed)
        start = 0
        if self.ckpt and self.ckpt.latest_step() is not None:
            start, host = self.ckpt.restore(
                {"params": state["params"], "opt": state["opt"]})
            state = map_tree(lambda a: torch.as_tensor(a, device=self.device), host)
        return start, state

    # -- main loop ------------------------------------------------------------
    def run(self, num_steps: int, state=None, start_step: int = 0,
            report: Optional[TrainReport] = None) -> TrainReport:
        """Train until step ``num_steps``, from ``state`` (updated in place)
        at ``start_step`` or, without one, from the newest checkpoint or a
        fresh initialisation."""
        report = report or TrainReport()
        if state is None:
            start_step, state = self.restore_or_init()
            if start_step:
                report.events.append(f"resumed from checkpoint step {start_step}")
        fn = self._fn()
        step = start_step
        while step < num_steps:
            # -- failure detection / restart -------------------------------
            failed = self.injector.fire(step, self.monitor)
            if failed or self.monitor.check():
                report.restarts += 1
                report.events.append(
                    f"step {step}: workers failed {sorted(failed)}; "
                    f"restarting from last checkpoint")
                for w in failed:            # replacement joins
                    self.monitor.revive(w)
                self.injector.schedule.pop(step, None)
                if self.ckpt:
                    self.ckpt.wait()
                    step, state = self.restore_or_init()
                continue

            batch = to_device(self.dataset.batch(step, self.global_batch),
                              self.device)
            t0 = time.perf_counter()
            try:
                params, opt, metrics = fn(state["params"], state["opt"], batch)
            except GuardTripError as e:
                report.guard_trips += 1
                report.events.append(f"step {step}: guard trip — retry ({e.detail})")
                continue
            # a tripped channel guard means a corrupted exchange: the step's
            # result is untrusted (and was applied in place), so recover
            # from the last checkpoint
            if float(metrics.get("guard_ok", 1)) == 0:
                report.guard_trips += 1
                report.events.append(
                    f"step {step}: channel guard tripped — restoring "
                    f"last checkpoint")
                if self.ckpt:
                    self.ckpt.wait()
                    step, state = self.restore_or_init()
                else:
                    state = self.init_state(self.tcfg.seed)
                    step = 0
                continue
            state = {"params": params, "opt": opt}
            loss = float(metrics["loss"])       # waits for the step
            dt = time.perf_counter() - t0
            if self.straggler.observe(dt):
                report.stragglers += 1
                report.events.append(
                    f"step {step}: straggler ({dt:.3f}s vs median "
                    f"{self.straggler.median:.3f}s)")
            report.losses.append(loss)
            report.steps_run += 1
            step += 1
            if self.tcfg.log_every and step % self.tcfg.log_every == 0:
                print(f"step {step:5d} loss {loss:8.4f} "
                      f"lr {float(metrics['lr']):.2e} "
                      f"gnorm {float(metrics['grad_norm']):.3f} "
                      f"({dt*1e3:.0f} ms)")
            if self.ckpt and step % self.tcfg.checkpoint_every == 0:
                self.save(step, state)
        if self.ckpt:
            self.save(num_steps, state, blocking=True)
        return report
