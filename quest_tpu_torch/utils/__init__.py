"""Utilities: profiling hooks (``utils.profiling``)."""

from . import profiling  # noqa: F401
