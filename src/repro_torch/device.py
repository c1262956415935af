"""Device selection for the port's entry points.

Entry points take ``device="cuda"`` by default and call :func:`resolve`,
which raises when CUDA is absent instead of carrying on on the CPU. Tests
pass ``device="cpu"`` to run the plain versions of the kernels;
``device="meta"`` builds shapes only, for a trace that counts a step
without running it (``launch.dryrun``). No entry point defaults to it.
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
    elif d.type not in ("cpu", "meta"):
        raise ValueError(f"unsupported device {device!r}")
    return d


class MetaGenerator(torch.Generator):
    """A generator whose ``device`` is meta: the port's initialisers draw
    on ``gen.device``, so ``init_params(cfg, MetaGenerator())`` builds the
    parameter tree's shapes and dtypes and allocates nothing."""

    @property
    def device(self) -> torch.device:
        return torch.device("meta")


def card_memory(device) -> int | None:
    """Bytes of memory on ``device`` if it is a CUDA card, else None."""
    d = resolve(device)
    return torch.cuda.get_device_properties(d).total_memory if d.type == "cuda" else None


def check_fits(what: str, nbytes: int, capacity: int | None) -> None:
    """Raise ValueError, saying why, when ``nbytes`` exceed ``capacity``
    (``card_memory``; None: not a card, nothing to check)."""
    if capacity is not None and nbytes > capacity:
        raise ValueError(f"{what} needs {nbytes / 1e9:.1f} GB, more than the "
                         f"card's {capacity / 1e9:.1f} GB")
