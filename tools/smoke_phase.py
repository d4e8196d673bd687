#!/usr/bin/env python3
"""Run named phases of ``chip_smoke.py`` alone on one NVIDIA card.

    python3 tools/smoke_phase.py PHASE [PHASE ...]

Builds every kernel (as the smoke does), prints the card's name and power
limit, then runs each PHASE in turn and prints its JSON line: ``prefix``
runs ``chip_smoke.prefix_phase`` over the seeded decode LM;
``kernels_f32``, ``kernels_bf16`` and ``kernels_f16`` run
``chip_smoke.kernel_checks`` at that dtype (rows 1-7 against their plain
versions, timed, at the paths' shapes) and ``threefry`` runs
``chip_smoke.threefry_checks``; ``bf16`` and ``f16`` run those 16-bit
phases (their serve legs without the f32 serve to compare batches with);
any other name is a ``chip_smoke`` phase
function taking only the failure list, named with or without its
``_phase`` suffix (``lowering`` runs ``lowering_phase``).
Prints the failures to stderr and one ``{"failures": N}`` line last; exits
1 if any phase failed.  Run from the root of the checkout.
"""
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
import torch  # noqa: E402


def main(argv) -> int:
    from cxxnet_tpu_torch.ops import build
    from cxxnet_tpu_torch.ops.precision import full_f32
    failures = []
    print(cs.nvidia_smi_line(), flush=True)
    t0 = time.perf_counter()
    build.build_all()
    print(json.dumps({'build_s': time.perf_counter() - t0}), flush=True)
    dev = torch.device('cuda', 0)
    peaks = cs.card_peaks(torch.cuda.get_device_name(0))
    dtypes = {'kernels_f32': torch.float32, 'kernels_bf16': torch.bfloat16,
              'kernels_f16': torch.float16}
    for name in argv:
        if name == 'prefix':
            params, cfg = cs._lm_params()
            with full_f32():
                cs.emit(cs.run_phase(cs.prefix_phase, failures, params, cfg))
        elif name in dtypes:
            with full_f32():
                rows = cs.run_phase(cs.kernel_checks, failures, dev, peaks,
                                    dtypes[name])
            cs.emit({'phase': 'kernel_checks', 'dtype': name[8:],
                     'rows': rows})
        elif name in ('bf16', 'f16'):
            # the 16-bit phases without the serve phase's f32 counts
            cs.emit(cs.run_phase(getattr(cs, name + '_phase'), failures,
                                 None))
        elif name == 'threefry':
            cs.emit({'phase': 'kernel_checks', **(cs.run_phase(
                cs.threefry_checks, failures, dev, peaks) or {})})
        else:
            fn = getattr(cs, name, None) or getattr(cs, name + '_phase')
            cs.emit(cs.run_phase(fn, failures))
    for f in failures:
        print('FAILED', f, file=sys.stderr)
    print(json.dumps({'failures': len(failures)}), flush=True)
    return 1 if failures else 0


if __name__ == '__main__':
    sys.exit(main(sys.argv[1:]))
