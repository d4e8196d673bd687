"""Cross-input block-diagonal conv fusion of ``cxxnet_tpu_torch``
(``fuse_blockdiag``) on the CPU, against the JAX package's
(``tests/test_blockdiag_fusion.py``).

* the same groups, execution order, sibling groups and conv+relu pairs
  as JAX's ``Net`` for explicit specs, ``auto`` and ``auto:<w>``,
  including ``googlenet_conf(num_class=4, aux_heads=False)`` (six
  groups; their members leave the conv kernel's pairing);
* fused against the port's unfused graph (forward, loss, three SGD
  steps) within ``BD_RTOL`` / ``BD_ATOL``, and against JAX's fused graph
  from the same weights within the train tolerance of
  ``tests/test_torch_train.py``;
* each refusal with JAX's error, and a randomized property: on any graph
  and pick the port fuses exactly when JAX does, and matches its own
  unfused graph when it does.
"""

import numpy as np
import pytest
import torch

from cxxnet_tpu.io.data import DataBatch as JBatch
from cxxnet_tpu.nnet.trainer import NetTrainer as JTrainer
from cxxnet_tpu.utils.config import parse_config_string as jparse
from cxxnet_tpu_torch.interop import params_from_jax
from cxxnet_tpu_torch.io.data import DataBatch
from cxxnet_tpu_torch.models.builders import alexnet_conf, googlenet_conf
from cxxnet_tpu_torch.nnet.net import Net as TGraph
from cxxnet_tpu_torch.nnet.net_config import NetConfig as TConfig
from cxxnet_tpu_torch.nnet.trainer import NetTrainer
from cxxnet_tpu_torch.runtime.faults import NotPortedError
from cxxnet_tpu_torch.utils.config import parse_config_string
from torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.torch_port


# fused against unfused: the fused conv contracts over the concatenated
# channels and the group's largest kernel, zero-padded, so its sums run
# over a longer axis in another blocking (the zero terms add exactly,
# the order does not); JAX's own twin holds its steps to the same
BD_RTOL, BD_ATOL = 1e-5, 1e-6
# fused against JAX's fused graph: the train tolerance of
# tests/test_torch_train.py (f32 sums in another order, a few updates)
TRAIN_RTOL, TRAIN_ATOL = 1e-4, 1e-6

# JAX's inception-v1-shaped module: two reduce convs off the trunk, a
# 3x3 (pad 1) and a 5x5 (pad 2) tower on different inputs, the 5x5
# reduce between the towers in config order
MODULE_CONF = """
netconfig = start
layer[0->r3] = conv:r3
  nchannel = 6
  kernel_size = 1
layer[r3->r3] = relu
layer[r3->t3] = conv:t3
  nchannel = 8
  kernel_size = 3
  pad = 1
layer[t3->t3] = relu
layer[0->r5] = conv:r5
  nchannel = 4
  kernel_size = 1
layer[r5->r5] = relu
layer[r5->t5] = conv:t5
  nchannel = 5
  kernel_size = 5
  pad = 2
layer[t5->t5] = relu
layer[0->t0] = conv:t0
  nchannel = 2
  kernel_size = 3
layer[t0->t0] = relu
layer[t3,t5->cat] = ch_concat
layer[cat->flat] = flatten
layer[flat->fc] = fullc:fc
  nhidden = 3
layer[fc->fc] = softmax
netconfig = end
%s
input_shape = 3,9,9
batch_size = 4
dev = cpu
eta = 0.05
momentum = 0.0
metric[label] = error
"""


def _trainer(extra: str) -> NetTrainer:
    tr = NetTrainer(parse_config_string(MODULE_CONF % extra))
    tr.init_model()
    return tr


def _jtrainer(extra: str) -> JTrainer:
    tr = JTrainer(jparse(MODULE_CONF % extra))
    tr.init_model()
    return tr


def _copy(src: NetTrainer, dst: NetTrainer) -> None:
    dst.params = {k: {f: v.detach().clone() for f, v in d.items()}
                  for k, d in src.params.items()}
    dst._post_params_init()


def _from_jax(jt: JTrainer, dst: NetTrainer) -> None:
    dst.params = params_from_jax({k: {f: np.asarray(v) for f, v in d.items()}
                                  for k, d in jt.params.items()})
    dst._post_params_init()


def _jscores(jt: JTrainer, x) -> np.ndarray:
    """JAX's final-node scores of host batch ``x``."""
    top = jt.net.cfg.layers[-1].nindex_out[-1]
    return np.asarray(jt._forward_nodes(JBatch(
        x, np.zeros((len(x), 1), np.float32)), [top])[0])


def _batch(seed=0, n=4):
    rng = np.random.RandomState(seed)
    return DataBatch(rng.rand(n, 3, 9, 9).astype(np.float32),
                     rng.randint(0, 3, n).astype(np.float32).reshape(-1, 1))


def _graphs(conf: str):
    from cxxnet_tpu.nnet.net import Net as JGraph
    from cxxnet_tpu.nnet.net_config import NetConfig as JConfig
    jc, tc = JConfig(), TConfig()
    jc.configure(jparse(conf))
    tc.configure(parse_config_string(conf))
    return JGraph(jc), TGraph(tc)


def _same_plan(jn, tn):
    assert tn._blockdiag_groups == jn._blockdiag_groups
    assert tn._exec_order == jn._exec_order
    assert tn._sibling_groups == jn._sibling_groups
    assert tn._convact_pairs == jn._convact_pairs
    assert tn._convact_solo == jn._convact_solo


# --- the same groups as JAX ---------------------------------------------------

@pytest.mark.parametrize('spec', ['t3+t5', 'r3+t5', 'auto', 'auto:4',
                                  'auto:8', '0'])
def test_groups_and_schedule_match_jax(spec):
    jn, tn = _graphs(MODULE_CONF % f'fuse_blockdiag = {spec}')
    _same_plan(jn, tn)


def test_schedule_reorder_pulls_producers_before_the_block():
    tn = _trainer('fuse_blockdiag = t3+t5').net
    names = [tn.cfg.layers[i].name for i in tn._exec_order]
    assert tn._exec_order != list(range(len(tn._exec_order)))
    i3, i5 = names.index('t3'), names.index('t5')
    assert abs(i3 - i5) == 1 and names.index('r5') < min(i3, i5)


def test_off_by_default_and_the_stderr_note(capsys):
    plain = _trainer('')
    assert plain.net._blockdiag_groups == {}
    assert plain.net._exec_order == list(range(len(plain.net.layers)))
    capsys.readouterr()
    _trainer('fuse_blockdiag = auto:4')
    assert 'fuse_blockdiag=auto:4: 0 group(s) formed — NO fusion engaged' \
        in capsys.readouterr().err
    _trainer('fuse_blockdiag = auto')
    assert 'fuse_blockdiag=auto: 1 group(s) formed' in capsys.readouterr().err


def test_auto_on_googlenet_groups_every_narrow_module():
    conf = googlenet_conf(num_class=4, aux_heads=False) + \
        '\nbatch_size = 1\nfuse_blockdiag = auto\n'
    jn, tn = _graphs(conf)
    _same_plan(jn, tn)
    groups = tn._blockdiag_group_set()
    assert {frozenset(tn.cfg.layers[m].name for m in g) for g in groups} == {
        frozenset({f'{p}_5x5', f'{p}_proj'})
        for p in ('in3a', 'in3b', 'in4a', 'in4b', 'in4c', 'in4d')}
    # the twelve members leave the conv kernel's pairing (JAX net.py:554)
    _, plain = _graphs(googlenet_conf(num_class=4, aux_heads=False)
                       + '\nbatch_size = 1\n')
    assert len(plain._convact_pairs) - len(tn._convact_pairs) == 12


def test_auto_is_silent_on_concat_free_nets():
    jn, tn = _graphs(alexnet_conf(num_class=4)
                     + '\nbatch_size = 1\nfuse_blockdiag = auto\n')
    assert tn._blockdiag_groups == {} == jn._blockdiag_groups


# --- fused against unfused, and against JAX's fused graph --------------------

@pytest.mark.parametrize('spec', ['t3+t5', 'r3+t5', 'auto'])
def test_forward_loss_and_steps_match_unfused(spec):
    plain = _trainer('')
    fused = _trainer(f'fuse_blockdiag = {spec}')
    assert fused.net._blockdiag_groups
    _copy(plain, fused)
    b = _batch(seed=7)
    np.testing.assert_allclose(fused.predict_scores(b.data),
                               plain.predict_scores(b.data),
                               rtol=BD_RTOL, atol=BD_ATOL)
    assert fused.evaluate(iter([b]), 'test') == \
        plain.evaluate(iter([b]), 'test')
    for i in range(3):
        b = _batch(seed=i)
        plain.update(b)
        fused.update(b)
        np.testing.assert_allclose(float(fused.last_loss),
                                   float(plain.last_loss), rtol=BD_RTOL)
    for k, d in plain.params.items():
        for f, v in d.items():
            np.testing.assert_allclose(fused.params[k][f].detach().numpy(),
                                       v.detach().numpy(), rtol=BD_RTOL,
                                       atol=BD_ATOL, err_msg=f'{k}/{f}')


@pytest.mark.parametrize('spec', ['t3+t5', 'auto'])
def test_fused_matches_jax_fused(spec):
    jt = _jtrainer(f'fuse_blockdiag = {spec}')
    tt = _trainer(f'fuse_blockdiag = {spec}')
    _from_jax(jt, tt)
    b = _batch(seed=3)
    np.testing.assert_allclose(tt.predict_scores(b.data),
                               _jscores(jt, b.data),
                               rtol=TRAIN_RTOL, atol=TRAIN_ATOL)
    for i in range(3):
        b = _batch(seed=i)
        jt.update(JBatch(b.data, b.label))
        tt.update(b)
    for k, d in jt.params.items():
        for f, v in d.items():
            np.testing.assert_allclose(tt.params[k][f].detach().numpy(),
                                       np.asarray(v), rtol=TRAIN_RTOL,
                                       atol=TRAIN_ATOL, err_msg=f'{k}/{f}')


def test_googlenet_module_fuses_and_matches():
    """One module of the builder's GoogLeNet (in-place relus, lazily
    emitted reduces): fused against unfused at full width, batch 1 (the
    module's plan against JAX's is ``test_auto_on_googlenet_...``'s)."""
    conf = googlenet_conf(num_class=4, aux_heads=False) + \
        '\nbatch_size = 1\ndev = cpu\n'
    fused = NetTrainer(parse_config_string(
        conf + 'fuse_blockdiag = in3a_3x3+in3a_5x5\n'))
    fused.init_model()
    plain = NetTrainer(parse_config_string(conf))
    plain.init_model()
    assert fused.net._blockdiag_groups
    _copy(plain, fused)
    x = np.random.RandomState(3).rand(1, 3, 224, 224).astype(np.float32)
    np.testing.assert_allclose(fused.predict_scores(x),
                               plain.predict_scores(x), rtol=BD_RTOL,
                               atol=BD_ATOL)


# --- refusals ----------------------------------------------------------------

_TEAR_CONF = """
netconfig = start
layer[0->x1] = conv:xc
  nchannel = 2
  kernel_size = 1
layer[0->a1] = conv:ac
  nchannel = 2
  kernel_size = 1
layer[x1->b1] = conv:bc
  nchannel = 2
  kernel_size = 1
layer[0->y1] = conv:yc
  nchannel = 2
  kernel_size = 1
netconfig = end
fuse_blockdiag = ac+bc;xc+yc
input_shape = 3,5,5
"""


@pytest.mark.parametrize('spec,match', [
    ('t3+nope', 'no layer named'),
    ('t3+t0', 'output grid mismatch'),
    ('r5+t5', 'chain fusion|different node'),
    ('t3+t5;t5+r3', 'appears in two groups'),
    ('t3', 'needs >=2 layer names'),
    ('auto:x', 'bad auto maxwidth'),
    ('t3+fc', 'is not a conv'),
], ids=['unknown', 'grid', 'chain', 'duplicate', 'single', 'maxwidth',
        'not_conv'])
def test_refusals_match_jax(spec, match):
    for make in (_jtrainer, _trainer):
        with pytest.raises(ValueError, match=match):
            make(f'fuse_blockdiag = {spec}')


def test_cross_group_tear_apart_refused():
    from cxxnet_tpu.nnet.net import Net as JGraph
    from cxxnet_tpu.nnet.net_config import NetConfig as JConfig
    for cfg_cls, graph, parse in ((JConfig, JGraph, jparse),
                                  (TConfig, TGraph, parse_config_string)):
        cfg = cfg_cls()
        cfg.configure(parse(_TEAR_CONF))
        with pytest.raises(ValueError, match='torn apart|not produced'):
            graph(cfg)


def test_grouped_conv_and_tensor_parallel_refused():
    # t3 (6 -> 8 channels) split into two groups
    grouped = MODULE_CONF.replace('  nchannel = 8\n',
                                  '  nchannel = 8\n  ngroup = 2\n', 1)
    for parse, cls in ((jparse, JTrainer), (parse_config_string,
                                            NetTrainer)):
        with pytest.raises(ValueError, match='ungrouped 1-in/1-out'):
            cls(parse(grouped % 'fuse_blockdiag = t3+t5')).init_model()
    # JAX refuses the pairing with tensor_parallel > 1; the port refuses
    # tensor_parallel itself (queue A item 9) before the pass runs
    with pytest.raises(ValueError, match='tensor_parallel'):
        _jtrainer('fuse_blockdiag = t3+t5\ntensor_parallel = 2')
    with pytest.raises(NotPortedError, match='tensor_parallel'):
        _trainer('fuse_blockdiag = t3+t5\ntensor_parallel = 2')


def test_explicit_group_dissolves_a_sibling_group():
    conf = MODULE_CONF % 'fuse_blockdiag = r3+t5'
    jn, tn = _graphs(conf)
    _same_plan(jn, tn)
    r3 = [i for i, info in enumerate(tn.cfg.layers) if info.name == 'r3'][0]
    assert r3 not in tn._sibling_groups
    assert tn._blockdiag_groups[r3]


# --- randomized property -----------------------------------------------------

def _random_conf(rng):
    lines = ['netconfig = start']
    nodes, convs = ['0'], []
    for i in range(rng.randint(3, 7)):
        src = nodes[rng.randint(len(nodes))]
        name = f'c{i}'
        k = int(rng.choice([1, 3]))
        lines += [f'layer[{src}->{name}] = conv:{name}',
                  f'  nchannel = {int(rng.choice([2, 3, 4]))}',
                  f'  kernel_size = {k}']
        if k == 3:
            lines += ['  pad = 1']
        if rng.rand() < 0.5:
            lines += [f'layer[{name}->{name}] = relu']
        convs.append(name)
        nodes.append(name)
    cat = ','.join(convs[-min(4, len(convs)):])
    lines += [f'layer[{cat}->cc] = ch_concat', 'layer[cc->fl] = flatten',
              'layer[fl->fc] = fullc:fc', '  nhidden = 3',
              'layer[fc->fc] = softmax', 'netconfig = end']
    return '\n'.join(lines), convs


def test_random_graphs_fused_or_refused_as_jax():
    from cxxnet_tpu.nnet.net import Net as JGraph
    from cxxnet_tpu.nnet.net_config import NetConfig as JConfig
    rng = np.random.RandomState(42)
    built = refused = 0
    for trial in range(20):
        conf, convs = _random_conf(rng)
        pick = list(rng.choice(convs, size=2, replace=False))
        base = conf + '\ninput_shape = 2,7,7\nbatch_size = 3\ndev = cpu\n' \
            'eta = 0.1\nmetric[label] = error\n'
        spec = base + f'fuse_blockdiag = {pick[0]}+{pick[1]}\n'
        jc = JConfig()
        jc.configure(jparse(spec))
        try:
            jn = JGraph(jc)
        except ValueError:
            jn = None
        try:
            fused = NetTrainer(parse_config_string(spec))
            fused.init_model()
        except ValueError as e:
            assert 'fuse_blockdiag' in str(e), f'trial {trial}: {e}'
            assert jn is None, f'trial {trial}: JAX fused {pick}'
            refused += 1
            continue
        assert jn is not None, f'trial {trial}: JAX refused {pick}'
        assert fused.net._exec_order == jn._exec_order
        built += 1
        plain = NetTrainer(parse_config_string(base))
        plain.init_model()
        _copy(plain, fused)
        x = rng.rand(3, 2, 7, 7).astype(np.float32)
        np.testing.assert_allclose(
            fused.predict_scores(x), plain.predict_scores(x), rtol=BD_RTOL,
            atol=BD_ATOL, err_msg=f'trial {trial}: fused {pick} diverged')
    assert built >= 3 and refused >= 3, (built, refused)


def test_blockdiag_weight_is_block_diagonal():
    """The fused weight of t3+t5: each member's weight centred in the
    5x5 window on its own input-channel block, zeros elsewhere."""
    tr = _trainer('fuse_blockdiag = t3+t5')
    net = tr.net
    members = next(iter(net._blockdiag_group_set()))
    seen = {}
    orig = net.__class__._fused_blockdiag_outputs

    def spy(self, params, values, ms):
        import cxxnet_tpu_torch.nnet.net as netmod
        real = netmod.conv_native

        def conv(x, w, strides, pad, groups=1):
            seen['w'], seen['pad'] = w.detach().clone(), pad
            return real(x, w, strides, pad, groups)
        netmod.conv_native = conv
        try:
            return orig(self, params, values, ms)
        finally:
            netmod.conv_native = real

    net._fused_blockdiag_outputs = spy.__get__(net)
    tr.predict_scores(_batch().data)
    w, (t3, t5) = seen['w'], members
    assert tuple(w.shape) == (5, 5, 6 + 4, 8 + 5)
    assert seen['pad'] == ((2, 2), (2, 2))
    w3 = tr.params[str(t3)]['wmat']
    w5 = tr.params[str(t5)]['wmat']
    assert torch.equal(w[1:4, 1:4, :6, :8], w3)
    assert torch.equal(w[:, :, 6:, 8:], w5)
    mask = torch.ones_like(w, dtype=torch.bool)
    mask[1:4, 1:4, :6, :8] = False
    mask[:, :, 6:, 8:] = False
    assert not w[mask].any()
