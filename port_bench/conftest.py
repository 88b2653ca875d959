"""The benchmark's own tests (``python -m pytest port_bench``): run on the
CPU at tiny sizes, apart from those marked ``cuda``, which decide inside
the test whether a card is there."""

import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
for p in (str(HERE.parent), str(HERE)):
    if p not in sys.path:
        sys.path.insert(0, p)
