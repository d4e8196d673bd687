"""Netconfig builders for the benchmark model families.

The port's own copy of ``cxxnet_tpu/models/builders.py`` (plain string
building, no JAX): each builder emits the same conf text as the JAX
package's.
"""

from __future__ import annotations


def mlp_conf(num_class: int = 10, input_dim: int = 784,
             nhidden: int = 100) -> str:
    """example/MNIST/MNIST.conf topology."""
    return f"""
netconfig=start
layer[+1:fc1] = fullc:fc1
  nhidden = {nhidden}
  init_sigma = 0.01
layer[+1:sg1] = sigmoid:se1
layer[sg1->fc2] = fullc:fc2
  nhidden = {num_class}
  init_sigma = 0.01
layer[+0] = softmax
netconfig=end
input_shape = 1,1,{input_dim}
"""


def lenet_conf(num_class: int = 10) -> str:
    """example/MNIST/MNIST_CONV.conf topology."""
    return f"""
netconfig=start
layer[0->1] = conv:cv1
  kernel_size = 3
  pad = 1
  stride = 2
  nchannel = 32
  random_type = xavier
layer[1->2] = max_pooling
  kernel_size = 3
  stride = 2
layer[2->3] = flatten
layer[3->3] = dropout
  threshold = 0.5
layer[3->4] = fullc:fc1
  nhidden = 100
  init_sigma = 0.01
layer[4->5] = sigmoid:se1
layer[5->6] = fullc:fc2
  nhidden = {num_class}
  init_sigma = 0.01
layer[6->6] = softmax
netconfig=end
input_shape = 1,28,28
"""


def alexnet_conf(num_class: int = 1000) -> str:
    """example/ImageNet/ImageNet.conf single-tower AlexNet topology
    (grouped convs 2/4/5, LRN after 1/2, three FCs with dropout)."""
    return f"""
netconfig=start
layer[0->1] = conv:conv1
  kernel_size = 11
  stride = 4
  nchannel = 96
layer[1->2] = relu
layer[2->3] = max_pooling
  kernel_size = 3
  stride = 2
layer[3->4] = lrn
  local_size = 5
  alpha = 0.001
  beta = 0.75
  knorm = 1
layer[4->5] = conv:conv2
  ngroup = 2
  nchannel = 256
  kernel_size = 5
  pad = 2
layer[5->6] = relu
layer[6->7] = max_pooling
  kernel_size = 3
  stride = 2
layer[7->8] = lrn
  local_size = 5
  alpha = 0.001
  beta = 0.75
  knorm = 1
layer[8->9] = conv:conv3
  nchannel = 384
  kernel_size = 3
  pad = 1
layer[9->10] = relu
layer[10->11] = conv:conv4
  nchannel = 384
  ngroup = 2
  kernel_size = 3
  pad = 1
layer[11->12] = relu
layer[12->13] = conv:conv5
  nchannel = 256
  ngroup = 2
  kernel_size = 3
  pad = 1
  init_bias = 1.0
layer[13->14] = relu
layer[14->15] = max_pooling
  kernel_size = 3
  stride = 2
layer[15->16] = flatten
layer[16->17] = fullc:fc6
  nhidden = 4096
  init_sigma = 0.005
  init_bias = 1.0
layer[17->18] = relu
layer[18->18] = dropout
  threshold = 0.5
layer[18->19] = fullc:fc7
  nhidden = 4096
  init_sigma = 0.005
  init_bias = 1.0
layer[19->20] = relu
layer[20->20] = dropout
  threshold = 0.5
layer[20->21] = fullc:fc8
  nhidden = {num_class}
layer[21->21] = softmax
netconfig=end
input_shape = 3,227,227
"""


def _conv_bn_relu(lines, src, dst, name, nch, ksize, stride=1, pad=0):
    lines.append(f'layer[{src}->{dst}] = conv:{name}')
    lines.append(f'  nchannel = {nch}')
    lines.append(f'  kernel_size = {ksize}')
    if stride != 1:
        lines.append(f'  stride = {stride}')
    if pad:
        lines.append(f'  pad = {pad}')
    lines.append('  no_bias = 1')
    lines.append(f'layer[{dst}->{dst}] = batch_norm:{name}_bn')
    lines.append(f'layer[{dst}->{dst}] = relu')
    return dst


def _inception(lines, src, prefix, n1, n3r, n3, nd3r, nd3, proj,
               pool='avg_pooling', stride=1):
    """Inception-BN module: 1x1 / 3x3 / double-3x3 / pool-proj branches,
    channel-concatenated."""
    outs = []
    if n1 > 0:
        b = f'{prefix}_1x1'
        _conv_bn_relu(lines, src, b, b, n1, 1)
        outs.append(b)
    b3r = f'{prefix}_3x3r'
    _conv_bn_relu(lines, src, b3r, b3r, n3r, 1)
    b3 = f'{prefix}_3x3'
    _conv_bn_relu(lines, b3r, b3, b3, n3, 3, stride=stride, pad=1)
    outs.append(b3)
    bd3r = f'{prefix}_d3x3r'
    _conv_bn_relu(lines, src, bd3r, bd3r, nd3r, 1)
    bd3a = f'{prefix}_d3x3a'
    _conv_bn_relu(lines, bd3r, bd3a, bd3a, nd3, 3, pad=1)
    bd3 = f'{prefix}_d3x3'
    _conv_bn_relu(lines, bd3a, bd3, bd3, nd3, 3, stride=stride, pad=1)
    outs.append(bd3)
    bp = f'{prefix}_pool'
    lines.append(f'layer[{src}->{bp}] = {pool}')
    lines.append('  kernel_size = 3')
    lines.append(f'  stride = {stride}')
    if stride == 1:
        lines.append('  pad = 1')   # same-size pool branch
    if proj > 0:
        bpp = f'{prefix}_proj'
        _conv_bn_relu(lines, bp, bpp, bpp, proj, 1)
        outs.append(bpp)
    else:
        outs.append(bp)
    dst = f'{prefix}_out'
    lines.append(f'layer[{",".join(outs)}->{dst}] = ch_concat')
    return dst


def inception_bn_conf(num_class: int = 1000) -> str:
    """GoogLeNet-family Inception with BatchNorm (Inception-BN /
    BN-Inception arrangement, cxxnet-era model zoo)."""
    lines = ['netconfig=start']
    top = _conv_bn_relu(lines, '0', 'conv1', 'conv1', 64, 7, stride=2, pad=3)
    _pool(lines, top, 'pool1', 'max_pooling', 3, 2)
    top = _conv_bn_relu(lines, 'pool1', 'conv2r', 'conv2r', 64, 1)
    top = _conv_bn_relu(lines, top, 'conv2', 'conv2', 192, 3, pad=1)
    _pool(lines, top, 'pool2', 'max_pooling', 3, 2)
    top = 'pool2'
    top = _inception(lines, top, 'in3a', 64, 64, 64, 64, 96, 32)
    top = _inception(lines, top, 'in3b', 64, 64, 96, 64, 96, 64)
    top = _inception(lines, top, 'in3c', 0, 128, 160, 64, 96, 0,
                     pool='max_pooling', stride=2)
    top = _inception(lines, top, 'in4a', 224, 64, 96, 96, 128, 128)
    top = _inception(lines, top, 'in4b', 192, 96, 128, 96, 128, 128)
    top = _inception(lines, top, 'in4c', 160, 128, 160, 128, 160, 128)
    top = _inception(lines, top, 'in4d', 96, 128, 192, 160, 192, 128)
    top = _inception(lines, top, 'in4e', 0, 128, 192, 192, 256, 0,
                     pool='max_pooling', stride=2)
    top = _inception(lines, top, 'in5a', 352, 192, 320, 160, 224, 128)
    top = _inception(lines, top, 'in5b', 352, 192, 320, 192, 224, 128,
                     pool='max_pooling')
    lines.append(f'layer[{top}->gpool] = avg_pooling')
    lines.append('  kernel_size = 7')
    lines.append('  stride = 1')
    lines.append('layer[gpool->flat] = flatten')
    lines.append('layer[flat->fc] = fullc:fc1')
    lines.append(f'  nhidden = {num_class}')
    lines.append('layer[fc->fc] = softmax')
    lines.append('netconfig=end')
    lines.append('input_shape = 3,224,224')
    return '\n'.join(lines) + '\n'


def _conv_relu(lines, src, dst, nch, ksize, stride=1, pad=0):
    """conv:{dst} + relu; the layer is named after its output node."""
    lines.append(f'layer[{src}->{dst}] = conv:{dst}')
    lines.append(f'  nchannel = {nch}')
    lines.append(f'  kernel_size = {ksize}')
    if stride != 1:
        lines.append(f'  stride = {stride}')
    if pad:
        lines.append(f'  pad = {pad}')
    lines.append(f'layer[{dst}->{dst}] = relu')
    return dst


def _pool(lines, src, dst, kind, ksize, stride, pad=0):
    lines.append(f'layer[{src}->{dst}] = {kind}')
    lines.append(f'  kernel_size = {ksize}')
    lines.append(f'  stride = {stride}')
    if pad:
        lines.append(f'  pad = {pad}')
    return dst


def _inception_v1(lines, src, prefix, n1, n3r, n3, n5r, n5, proj):
    """Original GoogLeNet inception module: 1x1 / 3x3 / 5x5 / pool-proj
    branches, channel-concatenated (4 inputs, the reference ch_concat
    maximum)."""
    b1 = _conv_relu(lines, src, f'{prefix}_1x1', n1, 1)
    b3r = _conv_relu(lines, src, f'{prefix}_3x3r', n3r, 1)
    b3 = _conv_relu(lines, b3r, f'{prefix}_3x3', n3, 3,
                    pad=1)
    b5r = _conv_relu(lines, src, f'{prefix}_5x5r', n5r, 1)
    b5 = _conv_relu(lines, b5r, f'{prefix}_5x5', n5, 5,
                    pad=2)
    bp = _pool(lines, src, f'{prefix}_pool', 'max_pooling', 3, 1, pad=1)
    bpp = _conv_relu(lines, bp, f'{prefix}_proj', proj, 1)
    dst = f'{prefix}_out'
    lines.append(f'layer[{b1},{b3},{b5},{bpp}->{dst}] = ch_concat')
    return dst


def _aux_head(lines, src, prefix, num_class):
    """GoogLeNet auxiliary classifier: avgpool5/3 -> 1x1 conv -> fc1024 ->
    dropout 0.7 -> fc -> softmax with grad_scale 0.3 (training-time
    regularizer; its loss adds to the main softmax's)."""
    _pool(lines, src, f'{prefix}_pool', 'avg_pooling', 5, 3)
    top = _conv_relu(lines, f'{prefix}_pool', f'{prefix}_conv', 128, 1)
    lines.append(f'layer[{top}->{prefix}_flat] = flatten')
    lines.append(f'layer[{prefix}_flat->{prefix}_fc1] = fullc:{prefix}_fc1')
    lines.append('  nhidden = 1024')
    lines.append(f'layer[{prefix}_fc1->{prefix}_fc1] = relu')
    lines.append(f'layer[{prefix}_fc1->{prefix}_fc1] = dropout')
    lines.append('  threshold = 0.7')
    lines.append(f'layer[{prefix}_fc1->{prefix}_fc2] = fullc:{prefix}_fc2')
    lines.append(f'  nhidden = {num_class}')
    lines.append(f'layer[{prefix}_fc2->{prefix}_fc2] = softmax')
    lines.append('  grad_scale = 0.3')


def googlenet_conf(num_class: int = 1000, aux_heads: bool = True) -> str:
    """Original GoogLeNet (inception v1): LRN instead of BN, and two
    auxiliary softmax classifiers (grad_scale 0.3) feeding the summed
    training loss — exercising the framework's multi-loss graphs."""
    lines = ['netconfig=start']
    top = _conv_relu(lines, '0', 'conv1', 64, 7, stride=2, pad=3)
    _pool(lines, top, 'pool1', 'max_pooling', 3, 2)
    lines.append('layer[pool1->pool1] = lrn')
    lines.append('  local_size = 5')
    top = _conv_relu(lines, 'pool1', 'conv2r', 64, 1)
    top = _conv_relu(lines, top, 'conv2', 192, 3, pad=1)
    lines.append(f'layer[{top}->{top}] = lrn')
    lines.append('  local_size = 5')
    _pool(lines, top, 'pool2', 'max_pooling', 3, 2)
    top = _inception_v1(lines, 'pool2', 'in3a', 64, 96, 128, 16, 32, 32)
    top = _inception_v1(lines, top, 'in3b', 128, 128, 192, 32, 96, 64)
    _pool(lines, top, 'pool3', 'max_pooling', 3, 2)
    top = _inception_v1(lines, 'pool3', 'in4a', 192, 96, 208, 16, 48, 64)
    if aux_heads:
        _aux_head(lines, top, 'aux1', num_class)
    top = _inception_v1(lines, top, 'in4b', 160, 112, 224, 24, 64, 64)
    top = _inception_v1(lines, top, 'in4c', 128, 128, 256, 24, 64, 64)
    top = _inception_v1(lines, top, 'in4d', 112, 144, 288, 32, 64, 64)
    if aux_heads:
        _aux_head(lines, top, 'aux2', num_class)
    top = _inception_v1(lines, top, 'in4e', 256, 160, 320, 32, 128, 128)
    _pool(lines, top, 'pool4', 'max_pooling', 3, 2)
    top = _inception_v1(lines, 'pool4', 'in5a', 256, 160, 320, 32, 128, 128)
    top = _inception_v1(lines, top, 'in5b', 384, 192, 384, 48, 128, 128)
    _pool(lines, top, 'gpool', 'avg_pooling', 7, 1)
    lines.append('layer[gpool->gpool_flat] = flatten')
    lines.append('layer[gpool_flat->gpool_flat] = dropout')
    lines.append('  threshold = 0.4')
    lines.append('layer[gpool_flat->fc] = fullc:loss3_fc')
    lines.append(f'  nhidden = {num_class}')
    lines.append('layer[fc->fc] = softmax')
    lines.append('netconfig=end')
    lines.append('input_shape = 3,224,224')
    return '\n'.join(lines) + '\n'


def vgg16_conf(num_class: int = 1000) -> str:
    """VGG-16 (configuration D, Simonyan & Zisserman 2014) — the era's
    third headline ImageNet family alongside AlexNet and GoogLeNet.  The
    reference ships no VGG conf; this follows the cxxnet-era model-zoo
    arrangement: five 3x3-conv blocks (2-2-3-3-3) with 2x2 max pooling,
    then fc4096-fc4096-fc{num_class} with dropout."""
    blocks = [(2, 64), (2, 128), (3, 256), (3, 512), (3, 512)]
    lines = ['netconfig=start']
    for b, (reps, ch) in enumerate(blocks, start=1):
        for r in range(1, reps + 1):
            lines += [f'layer[+1] = conv:conv{b}_{r}',
                      '  kernel_size = 3',
                      '  pad = 1',
                      f'  nchannel = {ch}',
                      'layer[+1] = relu']
        lines += ['layer[+1] = max_pooling',
                  '  kernel_size = 2',
                  '  stride = 2']
    lines += ['layer[+1] = flatten']
    for i, nh in ((6, 4096), (7, 4096)):
        lines += [f'layer[+1] = fullc:fc{i}',
                  f'  nhidden = {nh}',
                  'layer[+1] = relu',
                  'layer[+0] = dropout',
                  '  threshold = 0.5']
    lines += [f'layer[+1] = fullc:fc8',
              f'  nhidden = {num_class}',
              'layer[+0] = softmax',
              'netconfig=end',
              'input_shape = 3,224,224']
    return '\n'.join(lines) + '\n'
