"""Device selection for the port's entry points.

Entry points take ``device="cuda"`` by default and call :func:`resolve`,
which raises when CUDA is absent instead of carrying on on the CPU. Tests
pass ``device="cpu"`` to run the plain versions of the kernels.
"""
from __future__ import annotations

import torch


def resolve(device="cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises if it is CUDA and no CUDA
    device is present. On CUDA it also turns TF32 off for f32 products
    (``torch.backends.cuda.matmul.allow_tf32`` and
    ``torch.backends.cudnn.allow_tf32``), so f32 runs keep full f32
    precision as the reference does."""
    d = torch.device(device)
    if d.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass device='cpu' to "
                               "run the plain versions of the kernels")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif d.type != "cpu":
        raise ValueError(f"unsupported device {device!r}")
    return d
