"""The benchmark's CPU tests: `pytest port_bench/tests` from the repo root.
The harness's own folder and the repo root go on sys.path, as run.py puts
them."""
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
for p in (str(BENCH), str(BENCH.parent)):
    if p not in sys.path:
        sys.path.insert(0, p)
