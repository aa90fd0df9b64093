"""The benchmark's own tests: the checkout's root on ``sys.path`` so that
``portbench`` and the program import as a run imports them."""

import pathlib
import sys

REPO = pathlib.Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))
