#!/usr/bin/env python3
"""Whether a ``profile_dir`` trace window loses kernels, on one NVIDIA card.

    python3 tools/profiler_loss.py [--smoke] [--pairs N] [--sessions N]
                                   [--idle S] [--keep DIR]

Synthesizes the ``cli_imgbin`` dataset and runs the reference
``example/ImageNet/ImageNet.conf`` from the CLI in this process as the
smoke's ``obs`` phase runs it (batch 128, 2 rounds, a ``profile_dir``
window over updates 3-4), once with the warm-up burst after the
window's start (``utils/profiler.WARM_KERNELS``) and once without.
``--idle S`` varies something else in each pair: the burst is off in
both windows, and the first idles the host S seconds after the start.
``--sessions N`` then runs N short profiler sessions (start, 64 small
kernels, stop) and another such pair.  With ``--smoke`` it then runs
``chip_smoke.main()`` in this same process (every phase, the ``obs``
phase's window among them) and ``--pairs`` (default 4) more pairs, so
that the last windows run in a process older than the smoke's last
phase.  Each window prints one JSON line: the process's age, the burst,
the profiler's kernel events per name against the window's
``ops/launches`` delta, and ``chip_smoke.trace_kernel_counts``'s
diagnosis (the launches without their kernel and where they fall, the
burst's kernels traced, where the device events fall in the window, how
far CUPTI's clock stands from the host's).  ``--keep DIR`` gzips each
window's trace into DIR.  Exits 1 if a run or the smoke failed.  Run
from the root of the checkout.
"""
import argparse
import gzip
import json
import os
import shutil
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
import torch  # noqa: E402

T0 = time.monotonic()


def window(work, warm, idle, tag, keep):
    """One CLI run with a trace window whose start runs ``warm`` empty
    kernels, then idles ``idle`` seconds."""
    from cxxnet_tpu_torch.utils import profiler
    prof_dir = os.path.join(work, f'prof_{tag}')
    start = profiler.start_profiler

    def start_idle(sync=True):
        prof = start(sync)
        time.sleep(idle)
        return prof

    args = ['ImageNet.conf', f'num_round={cs.OBS_ROUNDS}',
            f'max_round={cs.OBS_ROUNDS}', f'batch_size={cs.OBS_BATCH}',
            'save_model=0', 'model_dir=models_edges',
            f'profile_dir={prof_dir}',
            f'profile_start_batch={cs.OBS_PROFILE[0]}',
            f'profile_stop_batch={cs.OBS_PROFILE[1]}']
    was, profiler.WARM_KERNELS = profiler.WARM_KERNELS, warm
    profiler.start_profiler = start_idle
    try:
        rc, _, err, _ = cs._cli_in_process(args, work)
    finally:
        profiler.WARM_KERNELS = was
        profiler.start_profiler = start
    out = {'window': tag, 'age_s': time.monotonic() - T0, 'warm': warm,
           'idle_s': idle, 'rc': rc}
    if rc != 0:
        out['stderr'] = [ln for _, ln in err[-20:]]
        return out
    pid = os.getpid()
    trace = os.path.join(prof_dir, f'trace_{pid}.json')
    diagnosis = {}
    traced, other = cs.trace_kernel_counts(trace, None, diagnosis)
    with open(os.path.join(prof_dir, f'launches_{pid}.json')) as f:
        counted = json.load(f)['launches']
    out.update(traced=traced, counted=counted, equal=traced == counted,
               other_kernels=other, diagnosis=diagnosis)
    if keep:
        with open(trace, 'rb') as src, \
                gzip.open(os.path.join(keep, f'{tag}.json.gz'), 'wb') as dst:
            shutil.copyfileobj(src, dst)
    return out


def sessions(n):
    """``n`` short profiler sessions of 64 small kernels each."""
    from cxxnet_tpu_torch.utils import profiler
    x = torch.ones(1024, device='cuda')
    for _ in range(n):
        prof = profiler.start_profiler()
        for _ in range(64):
            x.mul_(1.0)
        torch.cuda.synchronize()
        prof.stop()


def main(argv) -> int:
    from cxxnet_tpu_torch.ops import build
    from cxxnet_tpu_torch.utils import profiler
    ap = argparse.ArgumentParser()
    ap.add_argument('--smoke', action='store_true')
    ap.add_argument('--pairs', type=int, default=4)
    ap.add_argument('--sessions', type=int, default=0)
    ap.add_argument('--idle', type=float, default=0.0)
    ap.add_argument('--keep', default='')
    a = ap.parse_args(argv)
    if a.keep:
        os.makedirs(a.keep, exist_ok=True)
    print(cs.nvidia_smi_line(), flush=True)
    build.build_all()
    env = dict(os.environ)
    env['PYTHONPATH'] = os.pathsep.join(
        p for p in (ROOT, env.get('PYTHONPATH')) if p)
    failures, rc, rows = [], 0, []
    variants = ([(0, a.idle), (0, 0.0)] if a.idle
                else [(profiler.WARM_KERNELS, 0.0), (0, 0.0)])

    def pair(tag):
        for warm, idle in variants:
            rows.append(window(work, warm, idle, f'{tag}_{warm}_{idle}',
                               a.keep))
            print(json.dumps(rows[-1]), flush=True)

    with tempfile.TemporaryDirectory() as root:
        work, _ = cs._imgbin_workdir(root, env, failures, 'edges')
        pair('fresh')
        if a.sessions:
            sessions(a.sessions)
            pair(f'sessions{a.sessions}')
        if a.smoke:
            rc = cs.main([])
            print(json.dumps({'smoke_rc': rc,
                              'age_s': time.monotonic() - T0}), flush=True)
            for i in range(a.pairs):
                pair(f'aged{i}')
    bad = [r['window'] for r in rows if r['rc'] != 0]
    print(json.dumps({'failures': failures, 'runs_failed': bad,
                      'unequal': [r['window'] for r in rows
                                  if not r.get('equal')]}), flush=True)
    return 1 if failures or bad or rc else 0


if __name__ == '__main__':
    sys.exit(main(sys.argv[1:]))
