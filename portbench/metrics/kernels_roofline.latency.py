"""The kernels' share of the roofline of the slice's work, %."""
from portbench.core.readers import kernels_roofline as read  # noqa: F401
