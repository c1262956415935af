"""Per-(device, stream) scratch for the one-launch kernels.

``decode_attention``, ``guard_copy``, ``mac_batch`` and ``mac_update``
finish in one launch: their blocks write partial results to scratch memory
(``mac_update`` adds them into an accumulator kept among the zeroed
counter words) and count themselves in arrival counters; the last block of
a group merges the partials and sets its counter (and accumulator) back to
0. Two launches on one stream run one after the other, so
one scratch area per (kernel, device, stream) is enough, and it is reused
by every later call: no allocation on the hot path.

The counters are zeroed once, when the area is made or grown. A CUDA graph
records the pointers it was captured with, so the area must exist at its
final size before a capture: an eager call at the same shape on the
capture stream makes it, and a call that would grow it during a capture
raises. Areas that were outgrown are kept alive, since a captured graph
may still point at them.
"""
from __future__ import annotations

import threading
from typing import Dict, List, Tuple

import torch

_LOCK = threading.Lock()
# (kernel, device, stream) → (counters, scratch, n counters, n bytes, pointers)
_AREAS: Dict[Tuple[str, int, int], Tuple] = {}
_RETIRED: List[torch.Tensor] = []
_RAW_STREAM = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def current_stream(device_index: int) -> int:
    """The handle of the current CUDA stream of the device (without making a
    ``torch.cuda.Stream`` object where the build offers that)."""
    if _RAW_STREAM is not None:
        return _RAW_STREAM(device_index)
    return torch.cuda.current_stream(device_index).cuda_stream


def scratch(kernel: str, device_index: int, stream: int, *, counters: int,
            nbytes: int) -> Tuple[int, int]:
    """(counters pointer, scratch pointer) for ``kernel`` on the CUDA device
    ``device_index`` and ``stream`` (its handle): at least ``counters``
    int32 words, all 0 between launches, and ``nbytes`` bytes of scratch,
    16-byte aligned."""
    key = (kernel, device_index, stream)
    area = _AREAS.get(key)
    if area is not None and area[2] >= counters and area[3] >= nbytes:
        return area[4], area[5]
    with _LOCK:
        area = _AREAS.get(key)
        if area is None or area[2] < counters or area[3] < nbytes:
            if torch.cuda.is_current_stream_capturing():
                raise RuntimeError(
                    f"{kernel}: its workspace must exist before a CUDA graph capture "
                    f"(call it once at this shape on the capture stream first)")
            if area is not None:
                _RETIRED.extend(area[:2])
            n_c = max(counters, 2 * area[2] if area else 64)
            n_b = max(nbytes, 2 * area[3] if area else 1 << 16)
            device = torch.device("cuda", device_index)
            cnt = torch.zeros(n_c, dtype=torch.int32, device=device)
            buf = torch.empty(n_b, dtype=torch.uint8, device=device)
            area = _AREAS[key] = (cnt, buf, n_c, n_b, cnt.data_ptr(), buf.data_ptr())
        return area[4], area[5]
