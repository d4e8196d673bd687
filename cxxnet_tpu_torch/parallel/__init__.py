"""Parallelism: the world (``torch.distributed``), the ``('data',
'model')`` device mesh and sequence-parallel attention (counterpart of
``cxxnet_tpu/parallel``)."""

from .distributed import init_distributed, maybe_init_distributed
from .mesh import build_mesh
from .sequence import attention_reference, ring_attention, ulysses_attention
