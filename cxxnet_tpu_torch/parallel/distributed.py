"""Joining a multi-process world over ``torch.distributed``.

Counterpart of ``cxxnet_tpu/parallel/distributed.py``: the same typed
validation, retried and time-bounded connect, ``fresh=True`` rejoin and
environment contract, over ``torch.distributed.init_process_group``
instead of ``jax.distributed``.  Every process calls
:func:`init_distributed` with the same rendezvous address and world
size and its own rank; the backend is NCCL when the process computes on
a CUDA device and gloo when it computes on the CPU (``dev=cpu``).

``coordinator`` is ``host:port`` (a ``tcp://`` rendezvous, rank 0
listens there) or a full init URL such as ``file:///path`` (the CPU
tests' rendezvous).  Nothing here discovers a cluster: the caller gives
the address, the world size and the rank.
"""

from __future__ import annotations

import datetime
import os
import sys
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from ..runtime import faults
from ..utils.config import cfg_get, cfg_get_int

#: a rendezvous can stall indefinitely on a half-up coordinator; each
#: attempt gets this bound and the retry policy owns the patience
DEFAULT_INIT_TIMEOUT = 60.0

#: init_process_group raises RuntimeError flavors (DistNetworkError and
#: DistStoreError among them) on connect trouble: the policy retries them
DIST_INIT_RETRY = faults.RetryPolicy(
    retry_on=(OSError, TimeoutError, RuntimeError))


def _init_method(coordinator: str) -> str:
    return coordinator if '://' in coordinator else f'tcp://{coordinator}'


def init_distributed(coordinator: str, nproc: int, rank: int,
                     timeout: float = DEFAULT_INIT_TIMEOUT,
                     retry: Optional[faults.RetryPolicy] = None,
                     fresh: bool = False, device: Optional[str] = None
                     ) -> None:
    """Join (or, with ``fresh=True``, re-join) a ``torch.distributed``
    world of ``nproc`` processes as ``rank``, with typed validation and a
    retried connect whose attempts each wait at most ``timeout`` seconds.

    ``device`` is where this process computes: ``'cuda'`` (the default
    when a card is visible) takes NCCL and binds the process to card
    ``rank % device_count``; ``'cpu'`` takes gloo.  ``fresh=True``
    destroys a live default group first, so a process can rebuild its
    world after a membership change instead of wedging on the dead one."""
    if nproc < 1:
        raise faults.DistInitError(
            f'distributed world needs at least 1 process, got {nproc}')
    if not 0 <= rank < nproc:
        raise faults.DistInitError(
            f'worker rank {rank} out of range for a {nproc}-process '
            'world (check PS_RANK / dist_worker_rank vs '
            'CXXNET_NUM_WORKER / dist_num_worker)')
    if device is None:
        device = 'cuda' if torch.cuda.is_available() else 'cpu'
    device = torch.device(device).type
    if device == 'cuda':
        torch.cuda.set_device(rank % torch.cuda.device_count())
    backend = 'nccl' if device == 'cuda' else 'gloo'
    retry = DIST_INIT_RETRY if retry is None else retry

    def attempt():
        try:
            dist.init_process_group(
                backend, init_method=_init_method(coordinator),
                world_size=nproc, rank=rank,
                timeout=datetime.timedelta(seconds=timeout))
        except RuntimeError:
            # a half-initialized group must be torn down before the
            # retry, or every later attempt fails on "already initialized"
            if dist.is_initialized():
                dist.destroy_process_group()
            raise

    if fresh and dist.is_initialized():
        dist.destroy_process_group()
    try:
        retry.call(attempt, op_name='torch_distributed_init')
    except faults.RetryError as e:
        raise faults.DistInitError(
            f'torch.distributed world ({coordinator}, rank {rank}/'
            f'{nproc}, {backend}) failed to initialize: {e}') from e


def _env_int(name: str) -> Optional[int]:
    raw = os.environ.get(name, '').strip()
    if not raw:
        return None
    try:
        return int(raw)
    except ValueError:
        raise faults.DistInitError(
            f'{name}={raw!r} is not an integer') from None


def requested_world(cfg_pairs=()
                    ) -> Optional[Tuple[Optional[str], int, int]]:
    """The world the config and the environment ask for, as
    ``(coordinator, nproc, rank)``, or None when they ask for none.

    A world is asked for by ``param_server = dist`` (the reference's
    spelling) or a coordinator address in ``CXXNET_COORDINATOR`` /
    ``COORDINATOR_ADDRESS`` (``coordinator`` is None without one).  The
    world size comes from ``CXXNET_NUM_WORKER`` (else
    ``dist_num_worker``, 1), the rank from ``PS_RANK`` (else
    ``dist_worker_rank``, 0); a value that is not an integer raises
    :class:`~cxxnet_tpu_torch.runtime.faults.DistInitError`."""
    coord = os.environ.get('CXXNET_COORDINATOR',
                           os.environ.get('COORDINATOR_ADDRESS'))
    if cfg_get(cfg_pairs, 'param_server') != 'dist' and coord is None:
        return None
    nproc = _env_int('CXXNET_NUM_WORKER')
    if nproc is None:
        nproc = cfg_get_int(cfg_pairs, 'dist_num_worker', 1)
    rank = _env_int('PS_RANK')
    if rank is None:
        rank = cfg_get_int(cfg_pairs, 'dist_worker_rank', 0)
    return coord, nproc, rank


def maybe_init_distributed(cfg_pairs) -> bool:
    """Join the world :func:`requested_world` gives, if any, with the
    per-attempt bound from ``CXXNET_DIST_INIT_TIMEOUT`` and the backend
    from ``dev`` (gloo for ``dev=cpu``, else NCCL on a card).  Returns
    True if a world was joined."""
    world = requested_world(cfg_pairs)
    if world is None:
        return False
    coord, nproc, rank = world
    if nproc <= 1:
        if coord is not None:
            # a coordinator address with a 1-process world is almost
            # always a mis-set CXXNET_NUM_WORKER: say so instead of
            # silently running solo
            print('distributed: coordinator address set but '
                  f'num_workers={nproc} — running single-process '
                  '(set CXXNET_NUM_WORKER / dist_num_worker)',
                  file=sys.stderr, flush=True)
        return False
    if coord is None:
        raise faults.DistInitError(
            'param_server=dist needs a coordinator address '
            '(CXXNET_COORDINATOR / COORDINATOR_ADDRESS)')
    timeout = float(os.environ.get('CXXNET_DIST_INIT_TIMEOUT',
                                   str(DEFAULT_INIT_TIMEOUT)))
    dev = cfg_get(cfg_pairs, 'dev') or ''
    init_distributed(coord, nproc, rank, timeout=timeout,
                     device='cpu' if dev.startswith('cpu') else None)
    return True
