"""Data iterators: the batch contract and the chain factory (the MNIST
and image sources, augmentation, batching, thread and memory buffers;
``im2bin`` packs images into the ``imgbin`` format)."""

from .data import DataBatch, IIterator, create_iterator  # noqa: F401
