#!/usr/bin/env python3
"""Where a ``wrapper.Net.extract_stream`` pass over the reference ImageNet
conf's test chain spends its time on one NVIDIA card.

    python3 tools/torch_stream_split.py [--reps N]

Synthesizes ``chip_smoke.py``'s test set (300 seeded 256 x 256 JPEGs,
packed by the port's ``im2bin``), builds ``example/ImageNet/ImageNet.conf``
as written (the bf16 AlexNet at batch 256) from seeded random weights,
and reads the conf's own chain as a ``pred`` section (``imgbin``, the
centre crop, the mean image, made by a first pass that is not timed).
Prints one JSON line: the card's name and power limit, and

* ``chain_s``: one pass of the test chain alone;
* ``extract_s``: two ``extract_stream`` passes of node 19 (fc7's
  output), the first one the process's first forwards;
* ``batch_cast_copy_ms``: one batch's host bf16 cast and copy to the
  card (``Net.forward``'s input path), median of ``--reps``;
* ``batch_forward_ms``: one batch's forward with node 19's readback to
  the host, median of ``--reps``.

So it says how much of a pass an overlap of batch i+1's forward with
batch i's readback could save.
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from chip_smoke import (IMGBIN, _section_text, _synth_images,  # noqa: E402
                        nvidia_smi_line)

NODE = '19'


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--reps', type=int, default=5)
    args = ap.parse_args()
    import torch
    from cxxnet_tpu_torch import wrapper
    from cxxnet_tpu_torch.ops import build
    if not torch.cuda.is_available():
        sys.exit('no CUDA device')
    build.build_all()
    with open(os.path.join(ROOT, 'example', 'ImageNet',
                           'ImageNet.conf')) as f:
        conf_text = f.read()
    env = dict(os.environ)
    env['PYTHONPATH'] = os.pathsep.join(
        p for p in (ROOT, env.get('PYTHONPATH')) if p)
    with tempfile.TemporaryDirectory() as root:
        _synth_images(root, 'NameList.test', IMGBIN['test'],
                      IMGBIN['seed'] + 1)
        subprocess.run([sys.executable, '-m', 'cxxnet_tpu_torch.io.im2bin',
                        'NameList.test', 'img', 'TEST.BIN'], cwd=root,
                       env=env, check=True, stdout=subprocess.DEVNULL)
        os.makedirs(os.path.join(root, 'models'))
        with open(os.path.join(root, 'pred.conf'), 'w') as f:
            f.write(conf_text + '\npred = pred.txt\niter = imgbin\n'
                    '  image_list = "NameList.test"\n'
                    '  image_bin = "TEST.BIN"\n'
                    '  image_mean = "models/image_net_mean.bin"\n'
                    'iter = end\n')
        old_cwd = os.getcwd()
        os.chdir(root)
        try:
            net = wrapper.Net(cfg=conf_text)
            net.init_model()
            it = wrapper.DataIter(_section_text('pred.conf',
                                                ('pred', 'pred.txt')))
            it.before_first()
            while it.next():          # makes the mean image
                pass
            t0 = time.perf_counter()
            it.before_first()
            first = None
            while it.next():
                first = it.value if first is None else first
            chain_s = time.perf_counter() - t0
            passes = []
            for _ in range(2):
                t0 = time.perf_counter()
                for _ in net.extract_stream(it, NODE):
                    pass
                passes.append(time.perf_counter() - t0)
            tr, data = net.trainer, first.data
            nid = tr.net.node_index(NODE)
            cast, fwd = [], []
            for _ in range(args.reps):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                torch.from_numpy(np.asarray(data, np.float32)).to(
                    tr.dtype).to(tr.device)
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                tr.forward_values(tr.params, data)[nid].float().cpu()
                t2 = time.perf_counter()
                cast.append((t1 - t0) * 1e3)
                fwd.append((t2 - t1) * 1e3)
            it.close(10.0)
        finally:
            os.chdir(old_cwd)
    n = IMGBIN['test']
    print(json.dumps({
        'nvidia_smi': nvidia_smi_line(), 'images': n, 'node': NODE,
        'chain_s': chain_s, 'chain_images_per_s': n / chain_s,
        'extract_s': passes,
        'extract_images_per_s': [n / s for s in passes],
        'reps': args.reps,
        'batch_cast_copy_ms': float(np.median(cast)),
        'batch_forward_ms': float(np.median(fwd))}))


if __name__ == '__main__':
    main()
