"""The program's kernels' summed bound over their summed device time, %."""
from hpbench.readers import kernels_roofline as read  # noqa: F401
