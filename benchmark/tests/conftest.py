"""The benchmark's own CPU tests: ``python -m pytest benchmark/tests -q``
from the root of the repository.  They import the harness (``hlabench``)
and the port beside it, never JAX."""

import os
import sys

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for path in (os.path.dirname(BENCH), BENCH, os.path.dirname(__file__)):
    if path not in sys.path:
        sys.path.insert(0, path)
