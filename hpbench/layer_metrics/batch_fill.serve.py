"""Share of the batch slots filled with requests in the window, %."""
from hpbench.readers import batch_fill as read  # noqa: F401
