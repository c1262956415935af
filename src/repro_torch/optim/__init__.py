from repro_torch.optim.adamw import (adamw_update, clip_by_global_norm,
                                     cosine_lr, global_norm, init_opt_state)
from repro_torch.optim.compression import (compressed_reduce,
                                           compressed_tree_reduce,
                                           dequantize_int8, init_error_feedback,
                                           quantize_int8)

__all__ = ["adamw_update", "clip_by_global_norm", "cosine_lr", "global_norm",
           "init_opt_state", "compressed_reduce", "compressed_tree_reduce",
           "dequantize_int8", "init_error_feedback", "quantize_int8"]
