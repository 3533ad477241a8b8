"""The benchmark's own tests, on the CPU at tiny sizes: ``python -m
pytest bench/tests -q`` from the repository root. What needs the card
(the readings at the cells' own sizes) is ``bench/tools/calibrate.py``
and the benchmark's runs."""

import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
for p in (str(BENCH), str(BENCH.parent / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

