from repro_torch.roofline.analyze import (COLLECTIVES, HBM_BW, LINK_BW,
                                          PEAK_FLOPS, Roofline, bound,
                                          model_flops, moved_bytes)
from repro_torch.roofline.count import Cost, count, record_kernel

__all__ = ["COLLECTIVES", "HBM_BW", "LINK_BW", "PEAK_FLOPS", "Roofline",
           "bound", "model_flops", "moved_bytes", "Cost", "count",
           "record_kernel"]
