"""The benchmark's tests import its harness and the program from the
checkout; they run on the CPU (``python -m pytest benchmark/tests``), and
those marked ``gpu`` need the card."""
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
for p in (str(BENCH.parent), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)
