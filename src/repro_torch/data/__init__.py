"""Data pipeline of the port (numpy; the trainer moves batches to the
device)."""
from .pipeline import Prefetcher, SyntheticLM, make_batch_iterator  # noqa: F401
