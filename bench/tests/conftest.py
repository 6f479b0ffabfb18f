"""The benchmark's tests: run from the checkout's root with
``python -m pytest bench/tests`` (the ``cuda`` ones skip without a card;
on the card, ``-m cuda``)."""
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)
