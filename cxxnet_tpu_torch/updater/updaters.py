"""Updaters: per-weight optimizers and LR / momentum schedules.

PyTorch counterpart of ``cxxnet_tpu/updater/updaters.py``, with the
reference semantics it keeps (``src/updater/``):

* ``UpdaterHyper`` mirrors ``UpdaterParam`` (param.h:13-133): lr
  schedules ``constant/expdecay/polydecay/factor`` driven by the
  minibatch counter (the reference's ``epoch``), the ``lr_minimum``
  floor, the ``start_epoch`` gate, the momentum saturation schedule, the
  unconditional cap of momentum at ``final_momentum`` (param.h:88) and
  tag-scoped overrides — ``wmat:lr`` reaches only the updater whose tag
  is ``wmat``.  The schedule runs in float32, as the JAX package's does
  on the device.
* SGD (sgd_updater-inl.hpp:73-84): ``m = mom*m - lr*(clip(g) + wd*w);
  w += m``; the clip also zeroes NaN gradients and applies only when
  ``clip_gradient != 0``.
* NAG (nag_updater-inl.hpp:58-66): ``w += (1+mom)*m_new - mom*m_old``.
* Adam (adam_updater-inl.hpp:73-82): ``decay1/decay2`` are ``1-beta``;
  bias-corrected lr; the reference applies wd as ``grad -= wd*w`` and
  that sign is kept verbatim.

The JAX package's update is a pure function inside the jitted step;
here it updates the parameter and optimizer-state tensors in place
under ``torch.no_grad()``, which keeps one copy of each on the device.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

_F32 = np.float32


@dataclasses.dataclass
class UpdaterHyper:
    tag: str = ''
    base_lr: float = 0.01
    wd: float = 0.0
    momentum: float = 0.9
    lr_schedule: int = 0
    momentum_schedule: int = 0
    lr_step: int = 1
    lr_gamma: float = 0.5
    lr_alpha: float = 0.5
    lr_factor: float = 0.1
    lr_minimum: float = 0.00001
    start_epoch: int = 0
    base_momentum: float = 0.5
    final_momentum: float = 0.90
    saturation_epoch: int = 0
    clip_gradient: float = 0.0
    # adam
    decay1: float = 0.1
    decay2: float = 0.001

    def set_param(self, name: str, val: str) -> None:
        # tag-scoped override: 'wmat:lr' reaches only tag=='wmat'
        if self.tag and name.startswith(self.tag + ':'):
            name = name[len(self.tag) + 1:]
        if name in ('lr', 'eta'):
            self.base_lr = float(val)
        if name == 'wd':
            self.wd = float(val)
        if name == 'momentum':
            self.momentum = float(val)
        if name == 'momentum_schedule':
            self.momentum_schedule = int(val)
        if name == 'clip_gradient':
            self.clip_gradient = float(val)
        if name == 'final_momentum':
            self.final_momentum = float(val)
        if name == 'base_momentum':
            self.base_momentum = float(val)
        if name == 'saturation_epoch':
            self.saturation_epoch = int(val)
        if name == 'beta1':
            self.decay1 = float(val)
        if name == 'beta2':
            self.decay2 = float(val)
        if name.startswith('lr:') or name.startswith('eta:'):
            sub = name.split(':', 1)[1]
            if sub == 'schedule':
                table = {'constant': 0, 'expdecay': 1, 'polydecay': 2,
                         'factor': 3}
                if val in table:
                    self.lr_schedule = table[val]
            if sub == 'gamma':
                self.lr_gamma = float(val)
            if sub == 'alpha':
                self.lr_alpha = float(val)
            if sub == 'step':
                self.lr_step = int(val)
            if sub == 'factor':
                self.lr_factor = float(val)
            if sub == 'minimum_lr':
                self.lr_minimum = float(val)
            if sub == 'start_epoch':
                self.start_epoch = int(val)

    def schedule(self, epoch):
        """``(lr, momentum)`` as float32 numbers at minibatch counter
        ``epoch`` (``ScheduleEpoch``, param.h:76-94)."""
        e = _F32(epoch)
        step = _F32(self.lr_step)
        if self.lr_schedule == 0:
            lr = _F32(self.base_lr)
        elif self.lr_schedule == 1:
            lr = _F32(self.base_lr) * np.power(_F32(self.lr_gamma), e / step)
        elif self.lr_schedule == 2:
            lr = _F32(self.base_lr) * np.power(
                _F32(1.0) + np.floor(e / step) * _F32(self.lr_gamma),
                _F32(-self.lr_alpha))
        elif self.lr_schedule == 3:
            lr = _F32(self.base_lr) * np.power(_F32(self.lr_factor),
                                               np.floor(e / step))
        else:
            raise ValueError('unknown lr schedule type')
        mom = _F32(self.momentum)
        if self.momentum_schedule and self.saturation_epoch:
            slope = _F32((self.final_momentum - self.base_momentum)
                         / self.saturation_epoch)
            mom = mom + (slope * e + _F32(self.base_momentum))
        # the reference caps momentum at final_momentum unconditionally
        # (param.h:88) — preserved
        mom = min(_F32(mom), _F32(self.final_momentum))
        lr = max(_F32(lr), _F32(self.lr_minimum))
        if self.start_epoch > 0 and e < self.start_epoch:
            lr = _F32(self.base_lr)
        return _F32(lr), _F32(mom)


def create_updater_hyper(updater_type: str, tag: str, defcfg, layercfg
                         ) -> UpdaterHyper:
    """Per-weight hyperparameters: replay the global, then the layer's
    config (``neural_net-inl.hpp:186-196``)."""
    if updater_type not in ('sgd', 'nag', 'adam'):
        raise ValueError(f'unknown updater type {updater_type}')
    h = UpdaterHyper(tag=tag)
    for name, val in defcfg:
        h.set_param(name, val)
    for name, val in layercfg:
        h.set_param(name, val)
    return h


def _clip(g: torch.Tensor, c: float) -> torch.Tensor:
    """Clip to [-c, c] and zero NaNs (``sgd_updater-inl.hpp:15-22``)."""
    return torch.nan_to_num(g, nan=0.0, posinf=float('inf'),
                            neginf=float('-inf')).clamp(-c, c)


def init_opt_state(updater_type: str, params) -> Dict[str, dict]:
    """Zero optimizer slots, one tree per slot, keyed like ``params``."""
    def zeros():
        return {lk: {fk: torch.zeros_like(w, requires_grad=False)
                     for fk, w in fields.items()}
                for lk, fields in params.items()}
    if updater_type in ('sgd', 'nag'):
        return {'m': zeros()}
    if updater_type == 'adam':
        return {'m1': zeros(), 'm2': zeros()}
    raise ValueError(f'unknown updater type {updater_type}')


def _sgd_leaf(w, g, m, lr, mom, h: UpdaterHyper) -> None:
    if h.clip_gradient != 0.0:
        g = _clip(g, h.clip_gradient)
    m.mul_(float(mom)).sub_(float(lr) * (g + h.wd * w))
    w.add_(m)


def _nag_leaf(w, g, m, lr, mom, h: UpdaterHyper) -> None:
    m_new = float(mom) * m - float(lr) * (g + h.wd * w)
    w.add_(float(_F32(1.0) + mom) * m_new - float(mom) * m)
    m.copy_(m_new)


def _adam_leaf(w, g, m1, m2, epoch, h: UpdaterHyper) -> None:
    if h.wd > 0.0:
        g = g - h.wd * w          # reference sign kept verbatim
    e1 = _F32(epoch) + _F32(1.0)
    fix1 = _F32(1.0) - np.power(_F32(1.0 - h.decay1), e1)
    fix2 = _F32(1.0) - np.power(_F32(1.0 - h.decay2), e1)
    lr_t = _F32(h.base_lr) * np.sqrt(_F32(fix2)) / _F32(fix1)
    m1.add_(h.decay1 * (g - m1))
    m2.add_(h.decay2 * (g * g - m2))
    w.sub_(float(lr_t) * (m1 / (m2.sqrt() + 1e-8)))


def apply_updates(updater_type: str,
                  hypers: Dict[str, Dict[str, UpdaterHyper]],
                  params, grads, opt_state, epoch) -> None:
    """One optimizer step, in place on ``params`` and ``opt_state``.
    ``hypers[layer_key][field]`` carries the per-tensor (tag-scoped)
    hyperparameters; ``epoch`` is the minibatch counter driving the
    schedules."""
    if updater_type not in ('sgd', 'nag', 'adam'):
        raise ValueError(f'unknown updater type {updater_type}')
    with torch.no_grad():
        for lk, fields in params.items():
            for fk, w in fields.items():
                h = hypers[lk][fk]
                g = grads[lk][fk]
                if updater_type == 'adam':
                    _adam_leaf(w, g, opt_state['m1'][lk][fk],
                               opt_state['m2'][lk][fk], epoch, h)
                    continue
                lr, mom = h.schedule(epoch)
                step = _sgd_leaf if updater_type == 'sgd' else _nag_leaf
                step(w, g, opt_state['m'][lk][fk], lr, mom, h)
