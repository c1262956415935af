from repro_torch.runtime.elastic import (elastic_restore, plan_fleet_scaling,
                                         plan_gateway_recovery,
                                         plan_outlier_ejection, plan_remesh,
                                         remesh)
from repro_torch.runtime.fault import (FailureInjector, GatewaySupervisor,
                                       GuardTripError, HeartbeatMonitor,
                                       StragglerDetector)
from repro_torch.runtime.serve import (EngineService, Request, ServingEngine,
                                       FleetHandler, encode_prompt,
                                       fleet_handler, register_engine_fleet,
                                       seeded_engine)
from repro_torch.runtime.steps import (make_decode_step, make_prefill_step,
                                       make_train_step)
from repro_torch.runtime.train_loop import Trainer, TrainReport

__all__ = ["plan_fleet_scaling", "plan_gateway_recovery",
           "plan_outlier_ejection", "plan_remesh", "remesh", "elastic_restore", "FailureInjector", "GatewaySupervisor",
           "GuardTripError", "HeartbeatMonitor", "StragglerDetector",
           "EngineService", "Request", "ServingEngine", "encode_prompt",
           "FleetHandler", "fleet_handler", "register_engine_fleet",
           "seeded_engine", "make_decode_step", "make_prefill_step",
           "make_train_step", "Trainer", "TrainReport"]
