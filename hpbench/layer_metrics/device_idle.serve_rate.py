"""Share of the traced window with no operation on the device, %."""
from hpbench.readers import device_idle as read  # noqa: F401
