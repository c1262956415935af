from repro_torch.optim.adamw import (adamw_update, clip_by_global_norm,
                                     cosine_lr, global_norm, init_opt_state)

__all__ = ["adamw_update", "clip_by_global_norm", "cosine_lr", "global_norm",
           "init_opt_state"]
