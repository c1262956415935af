"""What the examples share: the ``--device`` option and their checks."""
from __future__ import annotations

import argparse


def parser(doc: str) -> argparse.ArgumentParser:
    """An argument parser with the examples' ``--device`` (default cuda)."""
    ap = argparse.ArgumentParser(description=doc.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="where frames, models and kernels live (default "
                         "cuda; cpu runs the plain versions)")
    return ap


def check(cond, msg: str) -> None:
    """Raise when an example's check fails (it never prints and goes on)."""
    if not cond:
        raise AssertionError(msg)


def kernel_tiled(cfg):
    """A reduced configuration with its head widths raised to the kernels'
    smallest tiles, so that a demo runs the kernels of its path on the card
    (and the same model on the CPU): attention heads of 64 (flash attention
    takes 64, 80 or 128), SSD heads, states and chunks of 32 (the scan's
    multiples of 32). Depth, head counts, ``d_model`` and the vocabulary
    stay the reduced configuration's."""
    from repro_torch.configs import replace
    from repro_torch.kernels.flash_attention import HEAD_DIMS
    kw = {}
    if cfg.num_heads:
        kw["head_dim"] = min(HEAD_DIMS)
    if cfg.ssm is not None:
        kw["ssm"] = replace(cfg.ssm, head_dim=32, d_state=32, chunk_size=32)
    return replace(cfg, name=f"{cfg.name}-tiled", **kw)
