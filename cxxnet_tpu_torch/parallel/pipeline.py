"""Pipeline stages over the ``pipe`` dim of the transformer mesh.

Counterpart of ``cxxnet_tpu/parallel/pipeline.py``.  The JAX package
gives every ``pipe`` rank exactly one stage (the leading axis of its
local shard of the stage stack) and runs a GPipe schedule: microbatch m
enters stage 0 at tick m and leaves the last stage at tick ``m + S - 1``,
stage-to-stage hand-offs by ``ppermute``.  The port runs the schedule at
``pipe = 1``: one stage, the microbatches through it in order, stacked
back; the last stage's output is this rank's, so no broadcast is needed.
More than one pipe rank raises ``NotPortedError`` (ROADMAP.md queue A
item 9).
"""

from __future__ import annotations

from typing import Callable

import torch

from ..runtime.faults import NotPortedError


def pipeline_stage_loop(stage_fn: Callable, stage_params, xs, *,
                        num_stages: int, has_aux: bool = False):
    """Run the microbatches ``xs`` (M, mb, ...) through this rank's stage.

    ``stage_fn(params, x_mb) -> y_mb`` (same shape), or ``(y_mb, aux)``
    with ``has_aux=True``, aux a dict of scalars.  ``stage_params``: the
    local shard of the stacked params, every leaf with leading dim 1,
    passed to ``stage_fn`` squeezed.  Returns the (M, mb, ...) outputs,
    and with ``has_aux`` the aux leaves averaged over the microbatches
    (summed over stages, of which there is one)."""
    if num_stages != 1:
        raise NotPortedError(f'pipeline_stage_loop over {num_stages} pipe '
                             'ranks', 'queue A item 9')
    p_local = {k: a[0] for k, a in stage_params.items()}
    outs, auxes = [], []
    for x in xs:
        y = stage_fn(p_local, x)
        if has_aux:
            y, aux = y
            auxes.append(aux)
        outs.append(y)
    outs = torch.stack(outs)
    if not has_aux:
        return outs
    M = len(auxes)
    return outs, {k: sum(a[k] for a in auxes) / M for k in auxes[0]}


def split_microbatches(x, num_microbatches: int):
    """(B, ...) -> (M, B/M, ...)."""
    b = x.shape[0]
    if b % num_microbatches:
        raise ValueError(
            f'batch {b} not divisible by microbatches {num_microbatches}')
    return x.reshape(num_microbatches, b // num_microbatches, *x.shape[1:])
