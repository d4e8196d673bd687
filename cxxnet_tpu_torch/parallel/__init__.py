"""Attention building blocks (counterpart of ``cxxnet_tpu/parallel``)."""
