"""The paper's benchmark workload (§VI): a distributed word count (the port
of ``repro.core.wordcount``).

Service 1 (client) reads text, serializes a request, sends it to Service 2
(server); the server counts words and returns the count. The text is the
client's input and stays a numpy array on the host (:func:`make_text`, the
reference's generator, seeded and vectorized); the count runs on the
device where the request lies (:func:`count_words`, the space→non-space
transition count), and the handler answers with the count as 8
little-endian bytes on that device, which the transports carry back as
they carry any response.
"""
from __future__ import annotations

import numpy as np
import torch

_WORD_MIN, _WORD_MAX = 3, 8          # word lengths, single-space separated
_SPACE = ord(" ")


def make_text(n_words: int, seed: int = 0) -> np.ndarray:
    """Deterministic ASCII text with exactly ``n_words`` words, as uint8."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(_WORD_MIN, _WORD_MAX + 1, size=n_words)
    total = int(lengths.sum()) + max(0, n_words - 1)
    out = np.full(total, _SPACE, np.uint8)
    # word start offsets: cumulative lengths + separators
    starts = np.zeros(n_words, np.int64)
    starts[1:] = np.cumsum(lengths[:-1] + 1)
    letters = rng.integers(ord("a"), ord("z") + 1, size=int(lengths.sum()),
                           dtype=np.uint8)
    # scatter letters into non-space slots
    is_space = np.ones(total, bool)
    for off in range(_WORD_MAX):
        sel = starts + off
        ok = off < lengths
        is_space[sel[ok]] = False
    out[~is_space] = letters
    return out


def count_words(text_u8: torch.Tensor) -> torch.Tensor:
    """uint8 text → (1,) int64 word count (space→non-space transitions),
    computed on the text's device."""
    if text_u8.numel() == 0:
        return torch.zeros(1, dtype=torch.int64, device=text_u8.device)
    nonspace = text_u8 != _SPACE
    starts = (nonspace[1:] & ~nonspace[:-1]).sum() + nonspace[0]
    return starts.reshape(1).to(torch.int64)


def wordcount_handler(req: torch.Tensor) -> torch.Tensor:
    """A request's bytes (any dtype, read as bytes) → the count as 8
    little-endian bytes (uint8) on the request's device."""
    return count_words(req.contiguous().reshape(-1).view(torch.uint8)) \
        .view(torch.uint8)


def parse_count(resp) -> int:
    """The word count in a response (a tensor on any device or an array of
    its 8 bytes), read on the host."""
    if isinstance(resp, torch.Tensor):
        resp = resp.detach().contiguous().reshape(-1).view(torch.uint8).cpu().numpy()
    return int(np.frombuffer(np.ascontiguousarray(resp).tobytes()[:8], "<u8")[0])
