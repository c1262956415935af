from repro_torch.data.pipeline import Prefetcher, to_device
from repro_torch.data.synthetic import SyntheticDataset

__all__ = ["Prefetcher", "SyntheticDataset", "to_device"]
