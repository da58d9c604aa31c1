"""Synthetic data pipelines (counterpart of ``repro.data``)."""
from .synthetic import EmbedStream, TokenStream

__all__ = ["EmbedStream", "TokenStream"]
