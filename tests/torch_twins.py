"""The f16 twin of a port test, for the port's test files.

A test written for one 16-bit dtype takes that dtype as an argument with
a default (which pytest leaves to the default); ``@f16_twin(**args)``
registers beside it, in its module, the same test called with ``args``
(the f16 dtype) under the same parametrization, named with ``f16`` for
``bf16`` (or ``_f16`` after the name).  The bf16 test keeps its name and
its ids::

    from torch_twins import f16_twin

    @f16_twin(dtype=torch.float16)
    @pytest.mark.parametrize('c', [96, 256])
    def test_lrn_bf16_matches(c, dtype=torch.bfloat16): ...
"""

import functools
import sys


def f16_twin(**f16_args):
    def register(test):
        name = test.__name__
        name = (name.replace('bf16', 'f16') if 'bf16' in name
                else name + '_f16')

        @functools.wraps(test)
        def twin(*args, **kwargs):
            return test(*args, **kwargs, **f16_args)
        twin.__name__ = twin.__qualname__ = name
        setattr(sys.modules[test.__module__], name, twin)
        return test
    return register
