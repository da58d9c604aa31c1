"""Continuous-batching serving (counterpart of ``repro.serving``)."""
from .scheduler import ContinuousBatcher, Request

__all__ = ["ContinuousBatcher", "Request"]
