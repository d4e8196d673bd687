"""Two faults of the port against the JAX package, repaired, each held
against the JAX package on the CPU.

* **Sampled streams.**  The JAX package samples pick n of a stream with
  ``jax.random.categorical(keys[n], logits / temperature)`` over
  ``keys = split(PRNGKey(seed), max_new + 1)``.  The port computes the
  same keys and float32 uniforms in numpy (``utils/prng.py``): held
  bitwise against ``jax.random`` here.  Its Gumbel noise,
  ``-log(-log(u))`` in float32, matches JAX's to ``GUMBEL_TOL`` (the two
  float32 ``log`` implementations round apart in the last bit, which the
  outer ``log`` magnifies where ``-log(u)`` is small), and the two
  models' logits differ in their last bits, so sampled streams are held
  token-equal up to a near-tie: where a stream first differs, the port's
  perturbed top two (``logits / temperature + noise`` at that pick) lie
  within ``NEAR_TIE`` of each other and JAX's token is one of them.
  Inside the port every service stream stays bitwise its ``generate``.
* **The coordinator note.**  With a coordinator address set and a
  1-process world, the port's CLI prints the JAX CLI's note, word for
  word, to stderr and runs solo.
* **``continue=1`` over a counter of five digits.**  The newest
  ``<counter>.model`` is found by the counter's value and the file that
  matched is read, as the JAX CLI reads it: a directory holding only
  ``00012.model`` resumes at round 13 in both packages, with the same
  weights.
"""

import io
import os
import shutil


import numpy as np
import pytest

import jax
import jax.numpy as jnp

from cxxnet_tpu import main as jax_main
from cxxnet_tpu.models import transformer as JT
from cxxnet_tpu.parallel.distributed import \
    maybe_init_distributed as jax_maybe_init_distributed
from cxxnet_tpu.serve.decode import DecodeService as JaxDecodeService
import torch

from cxxnet_tpu_torch import main as port_main
from cxxnet_tpu_torch.interop import lm_params_from_jax
from cxxnet_tpu_torch.models import transformer as T
from cxxnet_tpu_torch.serve.decode import DecodeService
from cxxnet_tpu_torch.utils import prng
from cxxnet_tpu_torch.utils.config import parse_config_file

pytestmark = pytest.mark.torch_port

KW = dict(vocab_size=64, d_model=32, num_heads=4, d_ff=48, num_stages=2,
          seq_len=32, attn='local')
CFG, JCFG = T.TransformerConfig(**KW), JT.TransformerConfig(**KW)
TINY = np.finfo(np.float32).tiny
# seeds on both sides of 2^31 and 2^32, and negative: JAX (64-bit mode
# off) keeps a seed's low 32 bits
SEEDS = [0, 1, 42, 2 ** 31 + 7, 2 ** 40 + 3, -3]
# |port - JAX| Gumbel noise <= GUMBEL_TOL * max(|noise|, 1): at most
# 5.6 * 2^-24 over 20 seeds x 30000 draws
GUMBEL_TOL = 2.0 ** -20
# a pick may differ from JAX's only where the port's perturbed top two
# (float32 logits / temperature + Gumbel noise, values of order 1-10) are
# this close: the logits differ by ~1e-5 (two blocks of f32 products in
# two libraries) and the noise by GUMBEL_TOL
NEAR_TIE = 1e-3
TEMP = 0.8


# --- the key schedule ---------------------------------------------------------

@pytest.mark.parametrize('seed', SEEDS)
def test_threefry_keys_and_uniforms_bitwise_jax(seed):
    jkey = jax.random.PRNGKey(seed)
    key = prng.prng_key(seed)
    np.testing.assert_array_equal(key, np.asarray(jkey))
    jkeys = np.asarray(jax.random.split(jkey, 33))
    keys = prng.split(key, 33)
    assert keys.dtype == np.uint32
    np.testing.assert_array_equal(keys, jkeys)
    for shape in [(32768,), (2, 1000), (3, 64)]:
        for lo, hi in ((TINY, 1.0), (0.0, 1.0)):
            ju = np.asarray(jax.random.uniform(jnp.asarray(jkeys[7]), shape,
                                               jnp.float32, lo, hi))
            got = prng.uniform(keys[7], shape, lo, hi)
            assert got.dtype == np.float32 and got.shape == shape
            np.testing.assert_array_equal(got.view(np.uint32),
                                          ju.view(np.uint32))


@pytest.mark.parametrize('seed', SEEDS[:3])
def test_gumbel_rows_match_jax(seed):
    key = prng.split(prng.prng_key(seed), 4)[3]
    jg = np.asarray(jax.random.gumbel(jnp.asarray(key), (3, 1000)))
    for row in range(3):
        got = prng.gumbel_row(key, 1000, row)
        assert got.dtype == np.float32
        lim = GUMBEL_TOL * np.maximum(np.abs(jg[row]), 1.0)
        assert (np.abs(got - jg[row]) <= lim).all()
    # a (V,) draw is row 0 of any (rows, V) draw
    np.testing.assert_array_equal(
        prng.gumbel_row(key, 1000),
        -np.log(-np.log(prng.uniform(key, (1000,), TINY, 1.0))))


def _near_tie(perturbed, got, want):
    """Where two picks differ: both tokens are the perturbed top two and
    those lie within NEAR_TIE."""
    top = np.argsort(perturbed)[::-1][:2]
    return ({int(got), int(want)} == {int(t) for t in top}
            and perturbed[top[0]] - perturbed[top[1]] <= NEAR_TIE)


def test_picks_equal_jax_categorical():
    """One pick per row of (b, V) f32 logits at vocab 32768, b = 1 and 3,
    from 12 keys: the port's pick is ``jax.random.categorical``'s."""
    rng = np.random.RandomState(5)
    keys = prng.split(prng.prng_key(11), 12)
    for b in (1, 3):
        for n, key in enumerate(keys):
            logits = (rng.randn(b, 32768) * 3).astype(np.float32)
            want = np.asarray(jax.random.categorical(
                jnp.asarray(key), jnp.asarray(logits) / TEMP, axis=-1))
            got = T.pick_tokens(torch.from_numpy(logits), [TEMP] * b,
                                [key] * b, list(range(b)))
            for r in range(b):
                if got[r] != want[r]:
                    pert = logits[r] / np.float32(TEMP) \
                        + prng.gumbel_row(key, 32768, r)
                    assert _near_tie(pert, got[r], want[r]), (b, n, r)


# --- sampled streams against the JAX package ----------------------------------

def _jparams(seed):
    return JT.init_params(np.random.RandomState(seed), JCFG)


def _assert_stream_matches(params, prompt, row, got, want, temp, keys):
    """``got`` (the port's row ``row`` of a stream) equals ``want``
    (JAX's) up to the first pick, and that pick is a near-tie of the
    port's logits there (perturbed by row ``row`` of ``keys[n]``'s noise
    when ``temp > 0``)."""
    got, want = np.asarray(got), np.asarray(want)
    diff = np.flatnonzero(got != want)
    if not diff.size:
        return
    n = int(diff[0])
    toks = torch.from_numpy(np.concatenate(
        [np.asarray(prompt)[row], got[:n]])[None].astype(np.int64))
    with torch.inference_mode():
        logits = T.prefill_kv(params, toks, 0, CFG)[2][0].numpy()
    pert = logits if not temp else (
        logits / np.float32(temp)
        + prng.gumbel_row(keys[n], CFG.vocab_size, row))
    assert _near_tie(pert, got[n], want[n]), (n, got, want)


@pytest.mark.parametrize('b', [1, 2])
@pytest.mark.parametrize('seed', [3, 2 ** 32 + 9])
def test_sampled_generate_equals_jax(b, seed):
    jp = _jparams(b)
    params = lm_params_from_jax(jax.tree_util.tree_map(np.asarray, jp))
    prompt = np.random.RandomState(seed % 97).randint(
        0, 64, (b, 7)).astype(np.int32)
    want = np.asarray(JT.generate(jp, prompt, 16, JCFG, temperature=TEMP,
                                  rng=jax.random.PRNGKey(seed)))
    got = T.generate(params, prompt, 16, CFG, temperature=TEMP, rng=seed)
    assert got.shape == want.shape == (b, 16)
    keys = T.sample_keys(seed, 16)
    for r in range(b):
        _assert_stream_matches(params, prompt, r, got[r], want[r], TEMP,
                               keys)


def test_sampled_service_streams_equal_jax_and_port_generate():
    """Mixed greedy and sampled requests through both packages'
    ``DecodeService`` on the same weights: each port stream is JAX's
    (near-tie rule) and bitwise the port's own offline ``generate``."""
    jp = _jparams(4)
    host = jax.tree_util.tree_map(np.asarray, jp)
    params = lm_params_from_jax(host)
    rng = np.random.RandomState(8)
    jobs = [(rng.randint(0, 64, (1, int(rng.randint(1, 12)))).astype(
        np.int32), int(rng.randint(4, 14)), TEMP if i % 3 else 0.0, 50 + i)
        for i in range(6)]
    kw = dict(slots=3, pages=32, page_size=8, max_prompt=16,
              max_new_bound=16, flash_decode=0)
    jsvc = JaxDecodeService(host, JCFG, **kw)
    try:
        jreqs = [jsvc.submit_async(p, mn, t, s if t else None)
                 for p, mn, t, s in jobs]
        for r in jreqs:
            jsvc.batcher.wait(r)
        want = [r.result for r in jreqs]
    finally:
        jsvc.close(30)
    svc = DecodeService(params, CFG, device='cpu', **kw)
    try:
        reqs = [svc.submit_async(p, mn, t, s if t else None)
                for p, mn, t, s in jobs]
        for r in reqs:
            svc.batcher.wait(r)
        got = [r.result for r in reqs]
    finally:
        svc.close(30)
    for (p, mn, t, s), g, w in zip(jobs, got, want):
        assert len(g) == len(w) == mn
        off = T.generate(params, p, mn, CFG, temperature=t,
                         rng=s if t else None, flash=0)[0]
        np.testing.assert_array_equal(g, off)
        _assert_stream_matches(params, p, 0, g, w, t, T.sample_keys(s, mn))


# --- the CLI's note for a coordinator in a 1-process world --------------------

DEC_CONF = """task = serve
serve.mode = decode
serve.lm = "vocab=64;d_model=32;heads=4;d_ff=48;stages=1"
serve.slots = 2
serve.pages = 16
serve.page_size = 8
serve.max_prompt = 8
serve.max_new = 4
serve.requests = 2
pred = toks.txt
"""


def test_cli_notes_a_coordinator_in_a_one_process_world(tmp_path,
                                                        monkeypatch,
                                                        capsys):
    for var in ('COORDINATOR_ADDRESS', 'CXXNET_NUM_WORKER', 'PS_RANK'):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv('CXXNET_COORDINATOR', '127.0.0.1:9999')
    assert jax_maybe_init_distributed([]) is False
    note = capsys.readouterr().err.strip()
    assert 'running single-process' in note
    (tmp_path / 'dec.conf').write_text(DEC_CONF)
    monkeypatch.chdir(tmp_path)
    assert port_main.main(['dec.conf', 'dev=cpu']) == 0
    err = capsys.readouterr().err
    assert note in err.splitlines()
    assert not torch.distributed.is_initialized()
    assert len((tmp_path / 'toks.txt').read_text().splitlines()) == 2


# --- continue=1 adopts the model file that matched -------------------------

MLP_CONF = """netconfig=start
layer[+1:fc1] = fullc:fc1
  nhidden = 5
  init_sigma = 0.1
layer[+1:sg1] = sigmoid:se1
layer[sg1->fc2] = fullc:fc2
  nhidden = 3
  init_sigma = 0.1
layer[+0] = softmax
netconfig=end
input_shape = 1,1,8
batch_size = 4
dev = cpu
continue = 1
"""


def _resume(task, conf, model_dir):
    for name, val in parse_config_file(str(conf)) + [('model_dir',
                                                      str(model_dir))]:
        task.set_param(name, val)
    assert task._sync_latest_model()
    buf = io.BytesIO()
    task.net_trainer.save_model(buf)
    return task.start_counter, buf.getvalue()


@pytest.mark.parametrize('name', ['00012.model', '0012.model'])
def test_continue_reads_the_model_file_that_matched(tmp_path, name):
    conf = tmp_path / 'mlp.conf'
    conf.write_text(MLP_CONF)
    writer = port_main.LearnTask()
    for k, v in parse_config_file(str(conf)):
        writer.set_param(k, v)
    writer.net_trainer = writer._create_net()
    writer.net_trainer.init_model()
    writer.name_model_dir = str(tmp_path / 'src')
    writer.start_counter = 12
    writer._save_model()
    saved = (tmp_path / 'src' / '0012.model').read_bytes()
    runs = {}
    for pkg, task in (('jax', jax_main.LearnTask()),
                      ('port', port_main.LearnTask())):
        d = tmp_path / pkg
        os.makedirs(d)
        shutil.copy(tmp_path / 'src' / '0012.model', d / name)
        # an older, lower counter beside it is passed over
        shutil.copy(tmp_path / 'src' / '0012.model', d / '0003.model')
        runs[pkg] = _resume(task, conf, d)
    assert runs['port'][0] == runs['jax'][0] == 13
    assert runs['port'][1] == runs['jax'][1] == saved[4:]
