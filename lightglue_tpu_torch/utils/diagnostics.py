"""One-shot degraded-mode warnings (counterpart of
lightglue_tpu/utils/diagnostics.py): every fallback that changes the
executed path announces itself once per process."""

from __future__ import annotations

import warnings
from typing import Set


class DegradedModeWarning(UserWarning):
    """A requested fast path was replaced by a fallback."""


_seen: Set[str] = set()


def warn_once(key: str, message: str) -> bool:
    """Emit ``message`` as a DegradedModeWarning the first time ``key`` is
    seen; return True iff the warning fired."""
    if key in _seen:
        return False
    _seen.add(key)
    warnings.warn(message, DegradedModeWarning, stacklevel=3)
    return True


def reset() -> None:
    """Forget emitted warnings (for tests)."""
    _seen.clear()
