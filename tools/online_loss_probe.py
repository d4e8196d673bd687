#!/usr/bin/env python3
"""The losses of the reference ImageNet.conf on the online phase's data,
step by step, by composition and by the data's contrast, on one NVIDIA
card.

    python3 tools/online_loss_probe.py [STEPS [OUT]]

Builds the kernels, then for each run of ``RUNS`` synthesizes
``chip_smoke.online_phase``'s dataset with every class's quadrant lifted
by ``contrast`` times ``chip_smoke.IMGBIN_COLOURS`` (seeded JPEGs, the
mean image over the stream's first page), decodes the conf's train chain
(``imgbin``, crop and mirror) over the whole stream for as many passes as
``STEPS`` (default 27) needs, and trains a fresh trainer from the conf's
seed over those batches, a pass a round, in the run's composition and
with its CLI keys: the conf as written (``compute_type = bfloat16``, the
kernels where ``auto`` sends them), the stock composition (``use_pallas=0
fuse=0``: cuDNN convs, PyTorch's LRN and products) or
``compute_type=float32``.  Prints the card's name and power limit, then
one JSON line a run: the loss at each step and the first step whose loss
is not finite; with ``OUT``, the lines also go to that file.
"""
import json
import math
import os
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
import torch  # noqa: E402

COMPOSITIONS = {'as_written': (),
                'stock': ('use_pallas=0', 'fuse=0'),
                'float32': ('compute_type=float32',)}
#: (contrast, composition, CLI keys of the run): the conf as written (raw
#: pixels less the mean), then its inputs scaled to [0, 1) (``scale``, read
#: by every data section; the ``online`` phase's choice), then its learning
#: rates a tenth
RUNS = ((1.0, 'as_written', ()), (1.0, 'stock', ()), (1.0, 'float32', ()),
        (0.25, 'as_written', ()), (0.25, 'stock', ()),
        (0.1, 'as_written', ()), (0.1, 'stock', ()),
        (1.0, 'as_written', ('scale=0.00390625',)),
        (1.0, 'stock', ('scale=0.00390625',)),
        (1.0, 'as_written', ('wmat:lr=0.001', 'bias:lr=0.002')))


def _batches(root, contrast, extra, steps):
    """The conf's pairs with ``extra`` and ``steps`` train batches over
    the stream of JPEGs at ``contrast``."""
    from cxxnet_tpu_torch.io.iter_stream import append_records
    on = cs.ONLINE
    colours = tuple(tuple(int(v * contrast) for v in c)
                    for c in cs.IMGBIN_COLOURS)
    train = cs._online_records(root, 'online.train',
                               on['initial'] + on['appended'], on['seed'],
                               colours)
    append_records(os.path.join(root, 'STREAM.bin'),
                   os.path.join(root, 'STREAM.lst'), train[:on['initial']])
    conf = cs._online_conf(root)
    # the phase's CLI keys but its ``scale``: a run's own keys say it
    args = [a for a in cs._online_args(os.path.join(root, 'models'))
            if not a.startswith('scale=')]
    cfg, data, defcfg = cs._online_task_cfg(conf, args + list(extra))
    cs._static_chain(data, defcfg).close(10.0)      # the mean image
    append_records(os.path.join(root, 'STREAM.bin'),
                   os.path.join(root, 'STREAM.lst'), train[on['initial']:])
    it = cs._static_chain(data, defcfg)
    out = []
    while len(out) < steps:
        out.extend(it)
    it.close(10.0)
    return cfg, out[:steps]


def main(argv) -> int:
    from cxxnet_tpu_torch.nnet.trainer import NetTrainer
    from cxxnet_tpu_torch.ops import build
    steps = int(argv[0]) if argv else 27
    on = cs.ONLINE
    per_pass = (on['initial'] + on['appended']) // on['batch']
    print(cs.nvidia_smi_line(), flush=True)
    build.build_all()
    with open(argv[1] if len(argv) > 1 else os.devnull, 'w') as out:
        for contrast, name, extra in RUNS:
            with tempfile.TemporaryDirectory() as root:
                cfg, batches = _batches(root, contrast,
                                        COMPOSITIONS[name] + extra, steps)
                tr = NetTrainer(cfg)
                tr.init_model()
                losses = []
                for i, b in enumerate(batches):
                    tr.start_round(1 + i // per_pass)
                    tr.update(b)
                    losses.append(float(tr.last_loss))
                bad = [i + 1 for i, v in enumerate(losses)
                       if not math.isfinite(v)]
                line = json.dumps({
                    'contrast': contrast, 'composition': name,
                    'keys': list(extra), 'losses': losses,
                    'first_non_finite_step': bad[0] if bad else None})
                print(line, flush=True)
                out.write(line + '\n')
                out.flush()
                del tr, batches
                torch.cuda.empty_cache()
    return 0


if __name__ == '__main__':
    sys.exit(main(sys.argv[1:]))
