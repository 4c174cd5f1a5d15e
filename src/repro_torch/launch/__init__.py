"""Serving entry points: the continuous-batching engine and its CLI."""
