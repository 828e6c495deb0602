"""The whole step's share of the peak of the cell's precision, %."""
from portbench.core.readers import mfu as read  # noqa: F401
