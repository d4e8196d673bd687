#!/usr/bin/env python3
"""Python-API MNIST walkthrough on the PyTorch port (the twin of
``example/MNIST/mnist.py``, the reference's ``example/MNIST/mnist.py``):
train through the wrapper, inspect weights, predict from a DataIter and
from a raw numpy batch, extract features, evaluate by hand, keep
training.

Run ``example/MNIST/run.sh`` first to fetch the data into ``./data``,
then, from that directory::

    python cxxnet_tpu_torch/example/mnist.py [dev]

``dev`` is the device: the card (``cuda``) unless ``cpu`` is given.
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                '..', '..'))
from cxxnet_tpu_torch import wrapper as cxxnet  # noqa: E402

dev = sys.argv[1] if len(sys.argv) > 1 else 'cuda'

data = cxxnet.DataIter("""
iter = mnist
    path_img = "./data/train-images-idx3-ubyte.gz"
    path_label = "./data/train-labels-idx1-ubyte.gz"
    shuffle = 1
iter = end
input_shape = 1,1,784
batch_size = 100
""")
print('init data iter')

deval = cxxnet.DataIter("""
iter = mnist
    path_img = "./data/t10k-images-idx3-ubyte.gz"
    path_label = "./data/t10k-labels-idx1-ubyte.gz"
iter = end
input_shape = 1,1,784
batch_size = 100
""")

cfg = """
netconfig=start
layer[+1:fc1] = fullc:fc1
  nhidden = 100
  init_sigma = 0.01
layer[+1:sg1] = sigmoid:se1
layer[sg1->fc2] = fullc:fc2
  nhidden = 10
  init_sigma = 0.01
layer[+0] = softmax
netconfig=end

input_shape = 1,1,784
batch_size = 100
random_type = gaussian
"""

param = {'eta': 0.1, 'dev': dev, 'momentum': 0.9,
         'metric[label]': 'error'}

net = cxxnet.train_iter(cfg, data, 1, param, eval_data=deval)

# weight access by layer name + tag (reference on-disk layouts)
weights = [(layer, tag, net.get_weight(layer, tag))
           for layer in ('fc1', 'fc2') for tag in ('wmat', 'bias')]
for layer, tag, w in weights:
    print(f'{layer}.{tag}: {w.shape}')

data.before_first()
data.next()
print('predict')
pred = net.predict(data)                      # from the iterator's batch
dbatch = data.get_data()
print(dbatch.shape)
pred2 = net.predict(dbatch)                   # from a raw numpy batch
print('iter-vs-raw predict diff:', np.sum(np.abs(pred - pred2)))
print('iter-vs-raw extract diff:',
      np.sum(np.abs(net.extract(data, 'sg1') - net.extract(dbatch, 'sg1'))))


def eval_error(it):
    """Error rate of ``net`` over ``it``, by hand."""
    it.before_first()
    werr = wcnt = 0
    while it.next():
        label = it.get_label()
        pred = net.predict(it)
        werr += np.sum(label[:, 0] != pred[:])
        wcnt += len(label[:, 0])
    return float(werr) / wcnt


print('eval-error=%f' % eval_error(deval))

# keep training with raw batches
data.before_first()
while data.next():
    net.update(data.get_data(), data.get_label())

print('eval-error-after=%f' % eval_error(deval))
