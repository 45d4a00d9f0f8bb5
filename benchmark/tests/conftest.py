"""The benchmark's own tests: `python -m pytest benchmark/tests -q` from the
checkout's root. They import the harness as the runs do, with benchmark/
and the checkout's root on the path; card-only cases carry the `cuda`
marker and decide inside the test whether a card is there."""
import os
import sys

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
for path in (ROOT, BENCH):
    if path not in sys.path:
        sys.path.insert(0, path)
