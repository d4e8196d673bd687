#!/usr/bin/env python
"""Train a tiny causal LM on a ``(pipe, data, seq, model)`` mesh: the
port's twin of ``example/transformer/train_lm.py``.

Data parallelism over ``data`` and ring-attention sequence parallelism
over ``seq``, one process a rank: gloo ranks spawned on this host with
``--device cpu``, else one NCCL rank a card.  ``--ckpt_dir`` saves the
parameters every ``--save_every`` steps (and after the last) as native
step checkpoints (``nnet/sharded_ckpt.py``; rank 0 writes, the ranks
hold replicas) and resumes from the newest one; the JAX example writes
orbax there (a divergence, ROADMAP.md queue C), and its
``restore_sharded`` reads the port's dirs.  Pipeline and tensor
parallelism and MoE experts are not ported yet: ``--pp`` and ``--tp``
take 1 only (``--pp`` defaults to 1 here, 2 in the JAX example), and
``--experts`` raises ``NotPortedError``.

  python cxxnet_tpu_torch/example/train_lm.py --device cpu   # dp2 sp2, 4 ranks
  python cxxnet_tpu_torch/example/train_lm.py --dp 1 --sp 1  # one card
"""

import argparse
import os
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from cxxnet_tpu_torch.runtime.faults import NotPortedError  # noqa: E402


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument('--pp', type=int, default=1)
    ap.add_argument('--dp', type=int, default=2)
    ap.add_argument('--sp', type=int, default=2)
    ap.add_argument('--tp', type=int, default=1)
    ap.add_argument('--experts', type=int, default=0)
    ap.add_argument('--remat', action='store_true',
                    help='rematerialize blocks in backward (long-context '
                         'memory saver)')
    ap.add_argument('--steps', type=int, default=30)
    ap.add_argument('--seq', type=int, default=128)
    ap.add_argument('--batch', type=int, default=8)
    ap.add_argument('--ckpt_dir', default='',
                    help='native step checkpoint dir: save and resume')
    ap.add_argument('--save_every', type=int, default=10)
    ap.add_argument('--generate', type=int, default=0, metavar='N',
                    help='after training, decode N tokens from a training '
                         'prompt (KV-cached transformer.generate)')
    ap.add_argument('--temperature', type=float, default=0.0,
                    help='sampling temperature for --generate (0=greedy)')
    ap.add_argument('--device', default='cuda', choices=('cuda', 'cpu'),
                    help='cuda: one NCCL rank a card; cpu: gloo ranks')
    return ap


def _rank_main(rank: int, args, url: str) -> None:
    """One rank: join the world, train, and on rank 0 print the losses."""
    from cxxnet_tpu_torch.models.transformer import (TransformerConfig,
                                                     build_transformer_mesh,
                                                     generate, init_params,
                                                     make_train_step)
    from cxxnet_tpu_torch.parallel import init_distributed
    n = args.pp * args.dp * args.sp * args.tp
    init_distributed(url, n, rank, device=args.device)
    try:
        dev = (torch.device('cuda', torch.cuda.current_device())
               if args.device == 'cuda' else torch.device('cpu'))
        # GPipe microbatches must divide the per-data-rank batch: the most
        # the local batch allows, capped at the default of 4
        local_batch = args.batch // args.dp
        micro = max(m for m in (4, 3, 2, 1) if local_batch % m == 0)
        cfg = TransformerConfig(seq_len=args.seq, num_stages=args.pp,
                                num_microbatches=micro, remat=args.remat)
        mesh = build_transformer_mesh(n, args.pp, args.dp, args.sp, args.tp)
        say = rank == 0
        if say:
            shape = dict(zip(mesh.mesh_dim_names, mesh.shape))
            print(f'mesh: {shape}  experts={args.experts}', flush=True)
        step = make_train_step(cfg, mesh)
        params = init_params(np.random.RandomState(0), cfg, device=dev)
        start_step = 0
        if args.ckpt_dir:
            from cxxnet_tpu_torch.nnet import sharded_ckpt
            if sharded_ckpt.latest_step(args.ckpt_dir) is not None:
                params, start_step = sharded_ckpt.restore_sharded(
                    args.ckpt_dir, params)
                start_step += 1
                if say:
                    print(f'resumed from step {start_step - 1}',
                          flush=True)

        # synthetic copy-task data: predict the previous token
        rng = np.random.RandomState(1)
        tokens = rng.randint(0, cfg.vocab_size,
                             (args.batch, cfg.seq_len)).astype(np.int32)
        labels = np.roll(tokens, -1, axis=1).astype(np.int32)

        t0 = time.time()
        for i in range(start_step, args.steps):
            params, loss, _aux = step(params, tokens, labels)
            if say and (i % 10 == 0 or i == args.steps - 1):
                print(f'step {i:4d}  loss {float(loss):.4f}  '
                      f'({time.time() - t0:.1f}s)', flush=True)
            if args.ckpt_dir and ((i + 1) % args.save_every == 0
                                  or i == args.steps - 1):
                if rank == 0:
                    sharded_ckpt.save_tree_native(args.ckpt_dir, i, params)
                torch.distributed.barrier()
        if say and args.generate:
            prompt = tokens[:2, :8]
            out = generate(params, prompt, args.generate, cfg,
                           temperature=args.temperature,
                           rng=0 if args.temperature > 0 else None)
            for b in range(out.shape[0]):
                print(f'prompt {list(map(int, prompt[b]))} -> '
                      f'decoded {list(map(int, out[b]))}', flush=True)
    finally:
        torch.distributed.destroy_process_group()


def main(argv=None) -> int:
    ap = _parser()
    args = ap.parse_args(argv)
    if args.save_every <= 0:
        ap.error('--save_every must be >= 1')
    if args.pp != 1:
        raise NotPortedError(f'--pp {args.pp} (pipeline parallelism)',
                             'queue A item 9')
    if args.tp != 1:
        raise NotPortedError(f'--tp {args.tp} (tensor parallelism)',
                             'queue A item 9')
    if args.experts:
        raise NotPortedError(f'--experts {args.experts} (MoE)',
                             'queue A item 9')
    if args.batch % args.dp:
        ap.error(f'--batch {args.batch} must be divisible by --dp {args.dp}')
    n = args.pp * args.dp * args.sp * args.tp
    if args.device == 'cuda' and torch.cuda.device_count() < n:
        raise RuntimeError(f'{n} ranks need {n} CUDA devices, found '
                           f'{torch.cuda.device_count()} (--device cpu runs '
                           'gloo ranks)')
    with tempfile.TemporaryDirectory() as tmp:
        url = f'file://{tmp}/rendezvous'
        if n == 1:
            _rank_main(0, args, url)
        else:
            torch.multiprocessing.spawn(_rank_main, args=(args, url),
                                        nprocs=n, join=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
