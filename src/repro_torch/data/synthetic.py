"""Deterministic synthetic LM data (a copy of ``repro.data.synthetic``:
numpy only, the same streams bit for bit).

The batch for global step ``s`` is a pure function of (seed, s, arch) —
stateless, so a restarted/elastically-rescaled job resumes on exactly the
token stream it would have seen (the data half of the fault-tolerance
story; the port's tests hold it to the reference's).

The token stream must be LEARNABLE fast on CPU-sized models (modular
arithmetic streams grok too slowly): each dataset seed fixes a length-P
token pattern; every row is that pattern at a random phase with a fraction
of tokens corrupted uniformly. The bigram map pattern[j] → pattern[j+1] is
near-deterministic, so CE drops from ln V toward
  (1-ρ)·(-ln(1-ρ)) + ρ·ln V   (ρ = corruption rate)
within tens of steps — the signal train-loop tests and examples assert.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from repro_torch.configs.base import ModelConfig


class SyntheticDataset:
    PATTERN_LEN = 16
    CORRUPT = 0.05

    def __init__(self, cfg: ModelConfig, seq_len: int, seed: int = 0):
        self.cfg = cfg
        self.seq_len = seq_len
        self.seed = seed
        rule = np.random.default_rng(np.random.SeedSequence([seed, 0xA11CE]))
        self.pattern = rule.integers(0, cfg.vocab_size, self.PATTERN_LEN)

    def _rng(self, step: int, row: int) -> np.random.Generator:
        return np.random.default_rng(
            np.random.SeedSequence([self.seed, step, row]))

    def _row_tokens(self, rng, V, S):
        off = int(rng.integers(0, self.PATTERN_LEN))
        toks = self.pattern[(np.arange(S) + off) % self.PATTERN_LEN].copy()
        corrupt = rng.random(S) < self.CORRUPT
        toks[corrupt] = rng.integers(0, V, int(corrupt.sum()))
        return toks

    def sample(self, step: int, row: int) -> Dict[str, np.ndarray]:
        rng = self._rng(step, row)
        V, S = self.cfg.vocab_size, self.seq_len
        toks = self._row_tokens(rng, V, S)
        out = {"tokens": toks.astype(np.int32), "labels": toks.astype(np.int32)}
        if self.cfg.vision_tokens:
            out["vision_embeds"] = rng.standard_normal(
                (self.cfg.vision_tokens, self.cfg.vision_dim)).astype(np.float32) * 0.1
            lab = out["labels"].copy()
            lab[: self.cfg.vision_tokens] = -1
            out["labels"] = lab
        if self.cfg.enc_dec:
            out["frames"] = rng.standard_normal(
                (self.cfg.enc_ctx, self.cfg.d_model)).astype(np.float32) * 0.1
        return out

    def batch(self, step: int, global_batch: int) -> Dict[str, np.ndarray]:
        """Vectorized across rows; identical streams to per-row sample()
        (same per-row generator, same draw order)."""
        V, S, B = self.cfg.vocab_size, self.seq_len, global_batch
        rngs = [self._rng(step, r) for r in range(B)]
        toks = np.stack([self._row_tokens(r, V, S) for r in rngs])
        out = {"tokens": toks.astype(np.int32), "labels": toks.astype(np.int32)}
        if self.cfg.vision_tokens:
            out["vision_embeds"] = np.stack([
                r.standard_normal((self.cfg.vision_tokens, self.cfg.vision_dim))
                .astype(np.float32) * 0.1 for r in rngs])
            out["labels"] = out["labels"].copy()
            out["labels"][:, : self.cfg.vision_tokens] = -1
        if self.cfg.enc_dec:
            out["frames"] = np.stack([
                r.standard_normal((self.cfg.enc_ctx, self.cfg.d_model))
                .astype(np.float32) * 0.1 for r in rngs])
        return out
