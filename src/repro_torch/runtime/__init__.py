from repro_torch.runtime.fault import (FailureInjector, GuardTripError,
                                       HeartbeatMonitor, StragglerDetector)
from repro_torch.runtime.serve import (EngineService, Request, ServingEngine,
                                       encode_prompt)
from repro_torch.runtime.steps import (make_decode_step, make_prefill_step,
                                       make_train_step)
from repro_torch.runtime.train_loop import Trainer, TrainReport

__all__ = ["FailureInjector", "GuardTripError", "HeartbeatMonitor",
           "StragglerDetector", "EngineService", "Request", "ServingEngine",
           "encode_prompt", "make_decode_step", "make_prefill_step",
           "make_train_step", "Trainer", "TrainReport"]
