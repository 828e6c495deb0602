"""Image pairs to matches per second, matches on the host."""
from portbench.core.readers import pairs_per_s as read  # noqa: F401
