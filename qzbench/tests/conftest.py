"""The benchmark's own tests: ``python -m pytest qzbench/tests`` from the
root of a checkout.  They run on the CPU; those marked ``cuda`` need the
card and skip without one."""
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
