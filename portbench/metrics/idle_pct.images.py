"""The device's idle share of the traced slice, %."""
from portbench.core.readers import idle_pct as read  # noqa: F401
