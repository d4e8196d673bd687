"""PairTest: two implementations of a layer type run side by side.

PyTorch counterpart of ``cxxnet_tpu/layers/pairtest.py`` (the
reference's ``pairtest-A-B`` harness,
``src/layer/pairtest_layer-inl.hpp:75-199``): a master and a slave layer
run on the same inputs with the master's weights; an output whose
largest relative difference ``|a - b| / (|a| + |b| + 1e-6)`` exceeds the
tolerance (``pairtest_tol``, 1e-5) is reported on stdout, in the words
of the JAX layer's ``jax.debug.print``.  ``master:`` / ``slave:``
prefixed keys reach one side only (pairtest:127-136).  The graph's output,
and so its gradient, is the master's.
"""

from __future__ import annotations

import torch

from .base import ForwardContext, Layer, create_layer, layer_type_name


class PairTestLayer(Layer):
    type_name = 'pairtest'

    def __init__(self, master_type: int, slave_type: int, name=''):
        super().__init__(name)
        self.type_id = 1024 * master_type + slave_type
        self.master = create_layer(master_type, name=name)
        self.slave = create_layer(slave_type, name=name)
        self.tol = 1e-5
        self.type_name = (f'pairtest-{layer_type_name(master_type)}'
                          f'-{layer_type_name(slave_type)}')

    @property
    def param_fields(self):
        return self.master.param_fields

    def set_param(self, name, val):
        if name.startswith('master:'):
            self.master.set_param(name[len('master:'):], val)
        elif name.startswith('slave:'):
            self.slave.set_param(name[len('slave:'):], val)
        else:
            self.master.set_param(name, val)
            self.slave.set_param(name, val)
            if name == 'pairtest_tol':
                self.tol = float(val)

    def infer_shapes(self, in_specs):
        out_m = self.master.infer_shapes(in_specs)
        out_s = self.slave.infer_shapes(list(in_specs))
        for a, b in zip(out_m, out_s):
            if a != b:
                raise ValueError(
                    f'{self.type_name}: master/slave output shapes differ: '
                    f'{a} vs {b}')
        return out_m

    def init_params(self, key, in_specs, device='cpu'):
        # the slave shares the master's weights (pairtest:137-141)
        return self.master.init_params(key, in_specs, device)

    def forward(self, params, inputs, ctx: ForwardContext):
        out_m = self.master.forward(params, inputs, ctx)
        with torch.no_grad():
            out_s = self.slave.forward(params, inputs, ctx)
            for i, (a, b) in enumerate(zip(out_m, out_s)):
                err = float(((a - b).abs()
                             / (a.abs() + b.abs() + 1e-6)).max())
                if err > self.tol:
                    print(f'PairTest MISMATCH {self.type_name} out[{i}]: '
                          f'rel-err {err}', flush=True)
        return out_m
