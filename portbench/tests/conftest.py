"""The benchmark's tests: the repository's root on the path, so that
`portbench` and the port import as they do under `portbench/run.py`."""

import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if REPO not in sys.path:
    sys.path.insert(0, REPO)
