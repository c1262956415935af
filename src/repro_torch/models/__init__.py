from repro_torch.models.model import (decode_step, forward, init_decode_state,
                                      init_params, loss_fn)
from repro_torch.models.transformer import Impl

__all__ = ["decode_step", "forward", "init_decode_state", "init_params",
           "loss_fn", "Impl"]
