"""The exact-resume state of ``cxxnet_tpu_torch`` (``NetTrainer.
save_training_state`` / ``snapshot_training_state`` /
``load_training_state``, ``nnet/sharded_ckpt.py``) on the CPU, inside the
port and across the two packages.

* Inside the port: a resumed run is bitwise the uninterrupted one; a
  resume from the model file alone (momentum reset) is not.
* The native format across packages: for the same tree the port's
  ``save_tree_native`` and JAX's write byte-identical dirs (manifest,
  leaf files, packed blob, digest), bfloat16 leaves too; a dir the port
  wrote restores in JAX's ``restore_sharded`` and the reverse; a JAX
  orbax dir raises the port's named divergence.
* Resume across packages: JAX trains 3 steps and snapshots, then the
  port and JAX each resume 3 more; the reverse from the port's
  checkpoint.  Parameters agree within the dropout MLP's tolerance of
  ``tests/test_torch_prng.py`` (rtol 1e-5, atol 1e-6: f32 sums in
  another order), counters and the step exactly.
* The CLI: ``continue=1 exact_ckpt=1`` after one round is byte-equal to
  the uninterrupted two-round run, model file and sidecar.
* ``example/train_lm.py --ckpt_dir``: a run resumed from its newest step
  writes the uninterrupted run's last checkpoint byte for byte.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from cxxnet_tpu.io.data import DataBatch as JBatch
from cxxnet_tpu.nnet import sharded_ckpt as jsharded
from cxxnet_tpu.nnet.trainer import NetTrainer as JTrainer
from cxxnet_tpu.runtime import async_ckpt as jasync
from cxxnet_tpu.utils.config import parse_config_string as jparse
from cxxnet_tpu_torch.nnet import sharded_ckpt

from test_torch_runtime import (CLI_CONF, MLP_CONF, assert_bitwise, fresh,
                                state, synth_batches, write_mnist)

pytestmark = pytest.mark.torch_port

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# tests/test_torch_prng.py's dropout-MLP tolerance
XF_RTOL, XF_ATOL = 1e-5, 1e-6


def jfresh():
    tr = JTrainer(jparse(MLP_CONF))
    tr.init_model()
    return tr


def jbatches(n=8):
    return [JBatch(b.data, b.label) for b in synth_batches(n)]


def _same_dirs(a, b):
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b))
    for name in names:
        assert open(os.path.join(a, name), 'rb').read() == \
            open(os.path.join(b, name), 'rb').read(), name
    return names


# --- inside the port ---------------------------------------------------------------

def test_exact_resume_reproduces_trajectory(tmp_path):
    import io
    batches = synth_batches()
    ref = fresh()
    for b in batches:
        ref.update(b)
    t_a = fresh()
    for b in batches[:4]:
        t_a.update(b)
    t_a.save_training_state(str(tmp_path / 'exact'), 4)
    t_b = fresh()
    assert t_b.load_training_state(str(tmp_path / 'exact'),
                                   restore_params=True) == 4
    assert (t_b.epoch_counter, t_b.sample_counter) == (4, 4)
    for b in batches[4:]:
        t_b.update(b)
    assert_bitwise(state(t_b), state(ref))
    # the model file alone drops momentum: the resume diverges
    buf = io.BytesIO()
    t_a.save_model(buf)
    buf.seek(0)
    t_d = fresh()
    t_d.load_model(buf)
    t_d.sample_counter = 4
    for b in batches[4:]:
        t_d.update(b)
    assert not torch.equal(t_d.params['0']['wmat'], ref.params['0']['wmat'])


def test_load_training_state_keeps_weights_by_default(tmp_path):
    """Without ``restore_params`` only the optimizer side and counters
    are adopted, in place (the same tensors); a changed net is refused."""
    batches = synth_batches(n_batches=3)
    t_a = fresh()
    for b in batches:
        t_a.update(b)
    t_a.save_training_state(str(tmp_path / 'ex'), 3)
    t_b = fresh()
    w0, m0 = t_b.params['0']['wmat'], t_b.opt_state['m']['0']['wmat']
    before = w0.detach().clone()
    assert t_b.load_training_state(str(tmp_path / 'ex')) == 3
    assert t_b.params['0']['wmat'] is w0 and torch.equal(w0, before)
    assert t_b.opt_state['m']['0']['wmat'] is m0
    assert torch.equal(m0, t_a.opt_state['m']['0']['wmat'])
    assert t_b.sample_counter == 3
    wide = fresh(conf=MLP_CONF.replace('nhidden = 32', 'nhidden = 24'))
    with pytest.raises(ValueError, match='shape'):
        wide.load_training_state(str(tmp_path / 'ex'))


def test_exact_resume_unharmed_by_partial_sidecar_litter(tmp_path):
    batches = synth_batches(n_batches=6)
    t_a = fresh()
    for b in batches[:3]:
        t_a.update(b)
    d = str(tmp_path / 'exact')
    t_a.save_training_state(d, 3)
    os.makedirs(os.path.join(d, 'step_9.tmp.42'))
    os.makedirs(os.path.join(d, 'step_8.corrupt'))
    for b in batches[3:]:
        t_a.update(b)
    t_b = fresh()
    assert t_b.load_training_state(d, restore_params=True,
                                   fallback=True) == 3
    for b in batches[3:]:
        t_b.update(b)
    assert_bitwise(state(t_b), state(t_a))


# --- the native format across the packages ------------------------------------------

def test_same_tree_same_bytes_mixed_dtypes(tmp_path):
    import jax.numpy as jnp
    rng = np.random.RandomState(0)
    host = {'params': {'0': {'wmat': rng.randn(300, 400).astype(np.float32),
                             'bias': rng.randn(400).astype(np.float32)},
                       '10': {'wmat': rng.randn(4, 3).astype(np.float32)},
                       '2': {'bias': rng.randn(5).astype(np.float32)}},
            'half': rng.randn(700, 300).astype(np.float32),
            'counters': {'epoch': np.asarray(3, np.int64),
                         'sample': np.asarray(7, np.int64)}}
    jtree = dict(host, half=np.asarray(jnp.asarray(host['half']).astype(
        jnp.bfloat16)))
    ttree = {'params': {k: {f: torch.from_numpy(v) for f, v in d.items()}
                        for k, d in host['params'].items()},
             'half': torch.from_numpy(host['half']).to(torch.bfloat16),
             'counters': host['counters']}
    jsharded.save_tree_native(str(tmp_path / 'j'), 5, jtree)
    sharded_ckpt.save_tree_native(str(tmp_path / 't'), 5, ttree)
    names = _same_dirs(str(tmp_path / 'j' / 'step_5'),
                       str(tmp_path / 't' / 'step_5'))
    assert {'tree_manifest.json', 'packed_leaves.bin', 'ckpt_digest.json',
            'leaf_00002.bin', 'leaf_00004.bin'} == set(names)
    got, _ = sharded_ckpt.restore_sharded(str(tmp_path / 'j'), ttree)
    assert got['half'].dtype == torch.bfloat16
    assert torch.equal(got['half'], ttree['half'])
    jgot, _ = jsharded.restore_sharded(str(tmp_path / 't'), jtree)
    assert str(jgot['half'].dtype) == 'bfloat16'
    np.testing.assert_array_equal(np.asarray(jgot['half']).astype(np.float32),
                                  ttree['half'].float().numpy())
    assert jgot['counters']['sample'].shape == ()


def test_trainer_state_same_bytes_both_ways(tmp_path):
    """JAX's trainer snapshots after 3 steps; the port adopts that dir and
    writes its own state tree: byte-identical.  JAX then restores the
    port's dir bitwise."""
    jtr = jfresh()
    for b in jbatches(3):
        jtr.update(b)
    ck = jasync.AsyncCheckpointer(workers=2)
    ck.save_sharded_async(str(tmp_path / 'j'), 3,
                          jtr.snapshot_training_state())
    ck.wait()
    ck.close()
    tr = fresh()
    assert tr.load_training_state(str(tmp_path / 'j'),
                                  restore_params=True) == 3
    tr.save_training_state(str(tmp_path / 't'), 3)
    _same_dirs(str(tmp_path / 'j' / 'step_3'),
               str(tmp_path / 't' / 'step_3'))
    j2 = jfresh()
    assert j2.load_training_state(str(tmp_path / 't'),
                                  restore_params=True) == 3
    for part in ('params', 'grad_acc'):
        for key, leaf in sharded_ckpt.flatten_with_keys(
                getattr(tr, part), f'[{part!r}]'):
            lk, fk = key.split("']['")[1:3]
            np.testing.assert_array_equal(
                np.asarray(getattr(j2, part)[lk][fk.rstrip("']")]),
                leaf.detach().numpy())
    assert (j2.epoch_counter, j2.sample_counter, j2.round) == \
        (tr.epoch_counter, tr.sample_counter, tr.round)


def test_jax_orbax_dir_names_the_divergence(tmp_path):
    jtr = jfresh()
    jtr.update(jbatches(1)[0])
    jtr.save_training_state(str(tmp_path / 'orbax'), 1)
    tr = fresh()
    with pytest.raises(sharded_ckpt.OrbaxCheckpointError, match='queue C'):
        tr.load_training_state(str(tmp_path / 'orbax'))
    with pytest.raises(sharded_ckpt.OrbaxCheckpointError):
        tr.load_training_state(str(tmp_path / 'orbax'), fallback=True)
    assert sharded_ckpt.quarantined_steps(str(tmp_path / 'orbax')) == []


# --- resume across the packages ---------------------------------------------------

def _close(tr, jtr):
    for lk in jtr.params:
        for fk in jtr.params[lk]:
            np.testing.assert_allclose(
                tr.params[lk][fk].detach().numpy(),
                np.asarray(jtr.params[lk][fk]), rtol=XF_RTOL, atol=XF_ATOL,
                err_msg=f'{lk}/{fk}')
            np.testing.assert_allclose(
                tr.opt_state['m'][lk][fk].numpy(),
                np.asarray(jtr.opt_state['m'][lk][fk]), rtol=XF_RTOL,
                atol=XF_ATOL, err_msg=f'momentum {lk}/{fk}')
    assert (tr.epoch_counter, tr.sample_counter, tr.round) == \
        (jtr.epoch_counter, jtr.sample_counter, jtr.round)


def test_resume_jax_checkpoint_in_port(tmp_path):
    jb, tb = jbatches(6), synth_batches(6)
    jtr = jfresh()
    for b in jb[:3]:
        jtr.update(b)
    jsharded.save_tree_native(str(tmp_path / 'j'), 3,
                              jasync.host_tree(jtr.snapshot_training_state()))
    tr = fresh()
    assert tr.load_training_state(str(tmp_path / 'j'),
                                  restore_params=True) == 3
    for j, t in zip(jb[3:], tb[3:]):
        jtr.update(j)
        tr.update(t)
    _close(tr, jtr)


def test_resume_port_checkpoint_in_jax(tmp_path):
    jb, tb = jbatches(6), synth_batches(6)
    tr = fresh()
    for b in tb[:3]:
        tr.update(b)
    tr.save_training_state(str(tmp_path / 't'), 3)
    jtr = jfresh()
    assert jtr.load_training_state(str(tmp_path / 't'),
                                   restore_params=True) == 3
    for j, t in zip(jb[3:], tb[3:]):
        jtr.update(j)
        tr.update(t)
    _close(tr, jtr)


# --- the CLI and the LM example ---------------------------------------------------

def test_cli_continue_exact_ckpt_bitwise(tmp_path, capsys, monkeypatch):
    from cxxnet_tpu_torch.main import main as tmain
    write_mnist(str(tmp_path))
    (tmp_path / 'mlp.conf').write_text(CLI_CONF)
    monkeypatch.chdir(tmp_path)
    assert tmain(['mlp.conf', 'model_dir=full', 'exact_ckpt=1']) == 0
    assert tmain(['mlp.conf', 'model_dir=res', 'exact_ckpt=1',
                  'num_round=1']) == 0
    assert tmain(['mlp.conf', 'model_dir=res', 'exact_ckpt=1',
                  'continue=1']) == 0
    capsys.readouterr()
    assert (tmp_path / 'full' / '0002.model').read_bytes() == \
        (tmp_path / 'res' / '0002.model').read_bytes()
    _same_dirs(str(tmp_path / 'full' / 'exact_state' / 'step_2'),
               str(tmp_path / 'res' / 'exact_state' / 'step_2'))
    # without the sidecar the resume resets momentum: other bytes
    os.makedirs(tmp_path / 'nomom')
    for name in ('0000.model', '0001.model'):
        (tmp_path / 'nomom' / name).write_bytes(
            (tmp_path / 'full' / name).read_bytes())
    assert tmain(['mlp.conf', 'model_dir=nomom', 'continue=1']) == 0
    assert (tmp_path / 'nomom' / '0002.model').read_bytes() != \
        (tmp_path / 'full' / '0002.model').read_bytes()


def _train_lm(ckpt, steps):
    env = dict(os.environ, PYTHONPATH=ROOT)
    r = subprocess.run(
        [sys.executable, os.path.join(ROOT, 'cxxnet_tpu_torch', 'example',
                                      'train_lm.py'),
         '--device', 'cpu', '--dp', '1', '--sp', '1', '--steps', str(steps),
         '--seq', '16', '--batch', '2', '--ckpt_dir', ckpt,
         '--save_every', '2'],
        capture_output=True, text=True, env=env, timeout=300)
    assert r.returncode == 0, r.stderr
    return r.stdout


def test_train_lm_ckpt_dir_resumes_bitwise(tmp_path):
    full, res = str(tmp_path / 'full'), str(tmp_path / 'res')
    _train_lm(full, 5)
    assert sharded_ckpt.all_steps(full) == [4, 3, 1]
    _train_lm(res, 3)
    out = _train_lm(res, 5)
    assert 'resumed from step 2' in out
    _same_dirs(os.path.join(full, 'step_4'), os.path.join(res, 'step_4'))
    from cxxnet_tpu.models.transformer import TransformerConfig, init_params
    like = init_params(np.random.RandomState(0),
                       TransformerConfig(seq_len=16, num_stages=1))
    jgot, step = jsharded.restore_sharded(full, like)
    assert step == 4 and set(jgot) == {'embed', 'head', 'stages'}
