"""The ``('data', 'model')`` device mesh.

Counterpart of ``build_mesh`` in ``cxxnet_tpu/parallel/mesh.py``: a
``torch.distributed.device_mesh.DeviceMesh`` over the ranks of the
joined world (one rank per card, or per CPU process under gloo), laid
out ``(n // tp, tp)`` with the JAX package's dim names.  A sequence-
parallel call names one dim (``axis_name``) and runs its collectives on
that dim's process group.  The sharding rules of that module
(``param_shardings``, ``batch_sharding``, ``decode_mesh``,
``parse_shard``) come with data and tensor parallelism (ROADMAP.md
queue A item 9).
"""

from __future__ import annotations

from typing import Sequence, Union

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

MESH_DIMS = ('data', 'model')


def build_mesh(devices: Union[None, int, Sequence[int]] = None,
               tp: int = 1) -> DeviceMesh:
    """A ``(data, model)`` mesh over ``devices``: the ranks of the world
    (None), its first ``n`` ranks (an int) or the given ranks, ``tp`` of
    them along ``model``; over ``cuda`` under NCCL, ``cpu`` under gloo.
    Every rank of the world calls it (it creates the dims' process
    groups)."""
    if not dist.is_initialized():
        raise RuntimeError('build_mesh needs a joined world '
                           '(parallel.distributed.init_distributed)')
    if devices is None:
        ranks = list(range(dist.get_world_size()))
    elif isinstance(devices, int):
        ranks = list(range(devices))
    else:
        ranks = [int(r) for r in devices]
    n = len(ranks)
    if tp < 1 or n % tp:
        raise ValueError(f'tensor_parallel={tp} must divide {n} devices')
    device_type = 'cuda' if dist.get_backend() == 'nccl' else 'cpu'
    return DeviceMesh(device_type,
                      torch.tensor(ranks, dtype=torch.int64).reshape(
                          n // tp, tp),
                      mesh_dim_names=MESH_DIMS)
