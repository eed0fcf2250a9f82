"""Hand-written Hopper kernels of the port and their plain PyTorch versions.

``KERNEL_LAUNCHES`` counts launches per kernel: a wrapper adds one where it
launches its kernel and nowhere else (a CPU tensor takes the plain version
and counts nothing), so a run can show that its path went through the
kernels.  ``reset_launch_counts`` sets every count to 0.
"""
from collections import Counter

KERNEL_LAUNCHES: Counter = Counter()


def reset_launch_counts() -> None:
    KERNEL_LAUNCHES.clear()
