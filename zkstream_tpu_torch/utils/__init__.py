"""Logging and the tick-duration histogram."""

from .logging import Logger  # noqa: F401
from .metrics import Histogram  # noqa: F401
