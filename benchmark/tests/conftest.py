"""The benchmark's own tests: `python -m pytest benchmark/tests -q` from
the root of the checkout (the card-only ones, marked `cuda`, skip without
a card). They put the benchmark and the checkout's root on the path."""
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if HERE not in sys.path:
    sys.path.insert(0, HERE)
if os.path.dirname(HERE) not in sys.path:
    sys.path.append(os.path.dirname(HERE))
