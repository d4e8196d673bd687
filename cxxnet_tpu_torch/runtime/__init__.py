"""The training runtime: the failure taxonomy and fault plans
(``faults``), ``TrainSupervisor`` (``supervisor``), the background
checkpoint writer (``async_ckpt``), the native page reader and JPEG
decoder (``native``), and the C ABI's source (``cxxnet_wrapper.cc``)."""
