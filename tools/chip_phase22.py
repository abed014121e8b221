"""Build the kernels and run chip_smoke.py's phase 22 (the kernels
section of analysis/) alone on the card, for iterating on that phase.

    python3 tools/chip_phase22.py
"""
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

import chip_smoke  # noqa: E402


def main() -> int:
    from repro_torch import exact_products
    from repro_torch.kernels import _build
    exact_products()
    t0 = time.perf_counter()
    _build.build(_build.sources())
    chip_smoke.log(f"built in {time.perf_counter() - t0:.1f}s")
    chip_smoke.phase_kernels_section(torch.device("cuda"))
    print(chip_smoke.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
