"""Serving: the continuous-batching engine of the port."""
from .engine import Request, ServeEngine  # noqa: F401
