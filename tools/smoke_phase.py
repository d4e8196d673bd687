#!/usr/bin/env python3
"""Run named phases of ``chip_smoke.py`` alone on one NVIDIA card.

    python3 tools/smoke_phase.py PHASE [PHASE ...]

Builds every kernel (as the smoke does), prints the card's name and power
limit, then runs each PHASE in turn and prints its JSON line: ``prefix``
runs ``chip_smoke.prefix_phase`` over the seeded decode LM; any other
name is a ``chip_smoke`` phase function taking only the failure list,
named with or without its ``_phase`` suffix (``lowering`` runs
``lowering_phase``).
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


def main(argv) -> int:
    from cxxnet_tpu_torch.ops import build
    from cxxnet_tpu_torch.ops.precision import full_f32
    failures = []
    print(cs.nvidia_smi_line(), flush=True)
    t0 = time.perf_counter()
    build.build_all()
    print(json.dumps({'build_s': time.perf_counter() - t0}), flush=True)
    for name in argv:
        if name == 'prefix':
            params, cfg = cs._lm_params()
            with full_f32():
                cs.emit(cs.run_phase(cs.prefix_phase, failures, params, cfg))
        else:
            fn = getattr(cs, name, None) or getattr(cs, name + '_phase')
            cs.emit(cs.run_phase(fn, failures))
    for f in failures:
        print('FAILED', f, file=sys.stderr)
    print(json.dumps({'failures': len(failures)}), flush=True)
    return 1 if failures else 0


if __name__ == '__main__':
    sys.exit(main(sys.argv[1:]))
