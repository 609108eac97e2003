"""The benchmark's own modules (``perfbench/``) and the program (the
checkout's root) on the import path of these tests."""

import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
for p in (str(HERE / "tests"), str(HERE), str(HERE.parent)):
    if p not in sys.path:
        sys.path.insert(0, p)
