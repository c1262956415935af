from repro_torch.runtime.serve import (EngineService, Request, ServingEngine,
                                       encode_prompt)

__all__ = ["EngineService", "Request", "ServingEngine", "encode_prompt"]
