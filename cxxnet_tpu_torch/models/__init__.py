"""Model families beyond the netconfig CNNs (counterpart of
``cxxnet_tpu/models``)."""
