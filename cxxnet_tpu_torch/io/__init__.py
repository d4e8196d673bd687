"""Data iterators: the batch contract and the chain factory (the MNIST
source, thread and memory buffers)."""

from .data import DataBatch, IIterator, create_iterator  # noqa: F401
