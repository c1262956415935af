"""``python -m repro_torch.analysis`` — the mpklint CLI (see docs/analysis.md)."""
import sys

from repro_torch.analysis.engine import run

if __name__ == "__main__":
    sys.exit(run())
