"""Checkpointing of tensor trees (the port of ``repro.checkpoint``)."""
from .checkpointer import Checkpointer  # noqa: F401
