"""Per-instance augmentation (``src/io/iter_augment_proc-inl.hpp:21-246`` +
the affine pipeline of ``src/io/image_augmenter-inl.hpp:13-204``).

The port's own copy of ``cxxnet_tpu/io/iter_augment.py``, numpy and scipy
only: the same draws in the same order, so a chain's batches are bitwise
the JAX package's.

Stages, in reference order:

1. optional affine warp (rotation from ``max_rotate_angle``/``rotate``/
   ``rotate_list``, shear, scale, aspect ratio) — only active when those
   params are set (``NeedProcess``); scipy affine_transform replaces
   cv::warpAffine, constant fill ``fill_value`` (default 255),
2. crop to ``input_shape`` — random (``rand_crop``) or center, with
   deterministic overrides ``crop_y_start``/``crop_x_start``,
3. mirror — random (``rand_mirror``) or forced (``mirror=1``),
4. mean subtraction — per-channel ``mean_value`` or a mean *image* file
   (``image_mean``), built over one pass of the dataset and cached to disk
   on first use exactly like the reference,
5. random contrast/illumination, then ``scale``/``divideby``.

For flat inputs (``input_shape`` c==1,y==1) only scaling applies.

``device_normalize=1`` keeps the cropped uint8 pixels and hands the
trainer a ``NormSpec``: the net applies ``(x - mean) * scale`` on the
device, in f32, before the cast to the compute dtype.
"""

from __future__ import annotations

import os
import struct
import time

import numpy as np

from .data import DataInst, IIterator


class ImageAugmenter:
    """Affine warp stage (rotation/shear/scale/aspect)."""

    def __init__(self):
        self.max_rotate_angle = 0.0
        self.max_aspect_ratio = 0.0
        self.max_shear_ratio = 0.0
        self.min_crop_size = -1
        self.max_crop_size = -1
        self.rotate = -1.0
        self.rotate_list = []
        self.max_random_scale = 1.0
        self.min_random_scale = 1.0
        self.min_img_size = 0.0
        self.max_img_size = 1e10
        self.fill_value = 255

    def set_param(self, name, val):
        if name == 'max_rotate_angle':
            self.max_rotate_angle = float(val)
        if name == 'max_shear_ratio':
            self.max_shear_ratio = float(val)
        if name == 'max_aspect_ratio':
            self.max_aspect_ratio = float(val)
        if name == 'min_crop_size':
            self.min_crop_size = int(val)
        if name == 'max_crop_size':
            self.max_crop_size = int(val)
        if name == 'min_random_scale':
            self.min_random_scale = float(val)
        if name == 'max_random_scale':
            self.max_random_scale = float(val)
        if name == 'min_img_size':
            self.min_img_size = float(val)
        if name == 'max_img_size':
            self.max_img_size = float(val)
        if name == 'fill_value':
            self.fill_value = int(val)
        if name == 'rotate':
            self.rotate = float(val)
        if name == 'rotate_list':
            self.rotate_list = [int(t) for t in val.split(',') if t]

    def need_process(self) -> bool:
        if (self.max_rotate_angle > 0 or self.max_shear_ratio > 0
                or self.rotate > 0 or self.rotate_list):
            return True
        if self.min_crop_size > 0 and self.max_crop_size > 0:
            return True
        return False

    def process(self, data: np.ndarray, rng: np.random.RandomState,
                out_y: int, out_x: int) -> np.ndarray:
        """data: (c, h, w) → warped image, still larger than (out_y, out_x)
        when possible (the caller crops)."""
        if not self.need_process():
            return data
        from scipy import ndimage
        c, rows, cols = data.shape
        s = rng.rand() * self.max_shear_ratio * 2 - self.max_shear_ratio
        if self.max_rotate_angle > 0:
            angle = rng.randint(0, int(self.max_rotate_angle * 2) + 1) \
                - self.max_rotate_angle
        else:
            angle = 0
        if self.rotate > 0:
            angle = self.rotate
        if self.rotate_list:
            angle = self.rotate_list[rng.randint(0, len(self.rotate_list))]
        a = np.cos(angle / 180.0 * np.pi)
        b = np.sin(angle / 180.0 * np.pi)
        scale = rng.rand() * (self.max_random_scale
                              - self.min_random_scale) + self.min_random_scale
        ratio = rng.rand() * self.max_aspect_ratio * 2 \
            - self.max_aspect_ratio + 1
        hs = 2 * scale / (1 + ratio)
        ws = ratio * hs
        new_w = int(max(self.min_img_size,
                        min(self.max_img_size, scale * cols)))
        new_h = int(max(self.min_img_size,
                        min(self.max_img_size, scale * rows)))
        # forward matrix (reference image_augmenter:97-104), mapping
        # (x=col, y=row) source → destination
        M = np.array([[hs * a - s * b * ws, hs * b + s * a * ws],
                      [-b * ws, a * ws]], dtype=np.float64)
        tx = (new_w - (M[0, 0] * cols + M[0, 1] * rows)) / 2
        ty = (new_h - (M[1, 0] * cols + M[1, 1] * rows)) / 2
        # scipy works on (row, col) with inverse mapping
        Mrc = np.array([[M[1, 1], M[1, 0]], [M[0, 1], M[0, 0]]])
        inv = np.linalg.inv(Mrc)
        offset = -inv @ np.array([ty, tx])
        # warp in float32: affine_transform returns the INPUT dtype when no
        # output= is given, so uint8 sources would quantize interpolated
        # pixels and wrap cubic-spline overshoot (e.g. -3 -> 253)
        data = np.asarray(data, np.float32)
        out = np.empty((c, new_h, new_w), np.float32)
        for ch in range(c):
            out[ch] = ndimage.affine_transform(
                data[ch], inv, offset=offset, output_shape=(new_h, new_w),
                order=3, mode='constant', cval=self.fill_value)
        return out


class AugmentIterator(IIterator):
    """Serial by default (one sequential RNG, reference-exact stream).

    ``nworker = N`` switches to the pooled path: per-instance decode
    (``base.iter_thunks``) + augmentation fan across an order-preserving
    worker pool (``utils/parallel_pool.py``).  Per-instance RNG is then
    seeded from the **epoch-absolute instance index** — NOT drawn from a
    shared sequential stream — so the output is bitwise identical for
    any worker count (including N=1), replay-stability is preserved,
    and a pooled run is reproducible against another pooled run of any
    width.  (The pooled stream therefore differs from the legacy serial
    stream: pick one mode per experiment.)  Per-stage timings land on
    ``pipeline_stats()``.

    ``elastic_hosts = H`` / ``elastic_rank = h`` promote the same
    invariant from threads to hosts: this stage keeps the GLOBAL epoch-absolute enumeration
    of the source's thunk stream but materializes only instances with
    ``index % H == h`` — skipped thunks never decode (the work is
    deferred into the thunk), and the per-instance RNG still keys on
    the global index.  Interleaving the H hosts' streams round-robin
    therefore reconstructs the 1-host stream bitwise, at any host
    count.  Requires the pooled path (``nworker >= 1``): the serial
    path's shared sequential RNG cannot shard."""

    def __init__(self, base: IIterator):
        self.base = base
        self.nworker = 0            # 0 = legacy serial path
        self.elastic_hosts = 1      # per-host stream sharding (elastic)
        self.elastic_rank = 0
        self._stats = None
        self.shape = (0, 0, 0)      # (c, y, x)
        self.rand_crop = 0
        self.rand_mirror = 0
        self.mirror = 0
        self.crop_y_start = -1
        self.crop_x_start = -1
        self.scale = 1.0
        self.silent = 0
        self.name_meanimg = ''
        self.mean_vals = None       # per-channel values (ch order 0,1,2)
        self.max_random_contrast = 0.0
        self.max_random_illumination = 0.0
        self.seed_data = 0
        self.device_normalize = 0
        self.aug = ImageAugmenter()
        self._meanimg = None
        self._warned_dev_norm = False

    def set_param(self, name, val):
        self.base.set_param(name, val)
        self.aug.set_param(name, val)
        if name == 'nworker':
            self.nworker = max(0, int(val))
            if self.nworker and self._stats is None:
                from ..utils.metric import StatSet
                self._stats = StatSet()
        if name == 'elastic_hosts':
            self.elastic_hosts = max(1, int(val))
        if name == 'elastic_rank':
            self.elastic_rank = int(val)
        if name == 'input_shape':
            self.shape = tuple(int(t) for t in val.split(','))
        if name == 'seed_data':
            self.seed_data = int(val)
        if name == 'rand_crop':
            self.rand_crop = int(val)
        if name == 'silent':
            self.silent = int(val)
        if name == 'divideby':
            self.scale = 1.0 / float(val)
        if name == 'scale':
            self.scale = float(val)
        if name == 'image_mean':
            self.name_meanimg = val
        if name == 'crop_y_start':
            self.crop_y_start = int(val)
        if name == 'crop_x_start':
            self.crop_x_start = int(val)
        if name == 'rand_mirror':
            self.rand_mirror = int(val)
        if name == 'mirror':
            self.mirror = int(val)
        if name == 'max_random_contrast':
            self.max_random_contrast = float(val)
        if name == 'max_random_illumination':
            self.max_random_illumination = float(val)
        if name == 'mean_value':
            self.mean_vals = np.asarray(
                [float(t) for t in val.split(',')], np.float32)
        if name == 'device_normalize':
            self.device_normalize = int(val)

    def init(self):
        self.base.init()
        if self.name_meanimg:
            if os.path.exists(self.name_meanimg):
                if self.silent == 0:
                    print(f'loading mean image from {self.name_meanimg}')
                self._meanimg = _load_mean(self.name_meanimg)
            else:
                self._create_mean_img()

    def _process_raw(self, data, rng):
        """Affine + crop + mirror for ONE instance array — the stage-1
        body of ``_raw_iter``, factored out so the pooled path can run
        it per-worker with a per-instance RNG.  Draw order is exactly
        the serial path's (process → crop randints → mirror rand)."""
        c, ty, tx = self.shape
        data = self.aug.process(data, rng, ty, tx)
        if ty == 1 and c == 1:
            return data                   # flat input: no crop
        _, h, w = data.shape
        if h < ty or w < tx:
            raise ValueError(
                'Data size must be bigger than the input size to net.')
        yy, xx = h - ty, w - tx
        if self.rand_crop != 0 and (yy != 0 or xx != 0):
            yy = rng.randint(0, yy + 1)
            xx = rng.randint(0, xx + 1)
        else:
            yy //= 2
            xx //= 2
        if h != ty and self.crop_y_start != -1:
            yy = self.crop_y_start
        if w != tx and self.crop_x_start != -1:
            xx = self.crop_x_start
        crop = data[:, yy:yy + ty, xx:xx + tx]
        if (self.rand_mirror != 0 and rng.rand() < 0.5) or self.mirror == 1:
            crop = crop[:, :, ::-1]
        return crop

    def _raw_iter(self):
        """Instances after affine + crop + mirror, before mean/scale —
        used for mean-image computation."""
        rng = np.random.RandomState(self.seed_data)
        for inst in self.base:
            yield inst, self._process_raw(inst.data, rng)

    def _device_norm_active(self) -> bool:
        """uint8-through mode: crop/mirror on host, (x-mean)*scale deferred
        to the device step (NormSpec).  Random contrast/illumination are
        per-instance host-RNG draws baked into the pixels, so they force
        the host path."""
        if not self.device_normalize:
            return False
        c, ty, tx = self.shape
        if ty == 1 and c == 1:
            return False                    # flat input: host scale only
        if self.max_random_contrast > 0 or self.max_random_illumination > 0:
            if not self._warned_dev_norm and self.silent == 0:
                print('device_normalize=1 ignored: random contrast/'
                      'illumination require the host normalize path')
                self._warned_dev_norm = True
            return False
        return True

    def get_norm_spec(self):
        if not self._device_norm_active():
            return None
        from .data import NormSpec
        # host-path quirk preserved: a mean image whose shape mismatches
        # the input is silently skipped (see __iter__), so the deferred
        # spec must drop it too rather than crash the device broadcast
        mean_img = self._meanimg
        if mean_img is not None and tuple(mean_img.shape) != self.shape:
            mean_img = None
        return NormSpec(mean_img=mean_img, mean_vals=self.mean_vals,
                        scale=self.scale)

    def _finish_host(self, inst, crop, rng):
        """Host-normalize ONE cropped instance (contrast/illumination/
        mean/scale) — the stage-2 body of the serial ``__iter__``, same
        draw order (contrast rand, then illumination rand)."""
        c, ty, tx = self.shape
        if ty == 1 and c == 1:
            return DataInst(inst.index,
                            np.asarray(crop, np.float32) * self.scale,
                            inst.label, inst.extra_data)
        contrast = 1.0
        illum = 0.0
        if self.max_random_contrast > 0:
            contrast = rng.rand() * self.max_random_contrast * 2 \
                - self.max_random_contrast + 1
        if self.max_random_illumination > 0:
            illum = rng.rand() * self.max_random_illumination * 2 \
                - self.max_random_illumination
        out = crop.astype(np.float32)
        if self.mean_vals is not None:
            out = out - self.mean_vals[:, None, None]
        elif self._meanimg is not None:
            if self._meanimg.shape == out.shape:
                out = out - self._meanimg
        out = (out * contrast + illum) * self.scale
        return DataInst(inst.index, out, inst.label, inst.extra_data)

    def pipeline_stats(self):
        return self._stats

    def _inst_rng(self, i: int, salt: int) -> np.random.RandomState:
        """Pooled-path RNG for epoch-absolute instance ``i``: a fresh
        MT19937 seeded from (seed_data, salt, i) only, so any worker can
        compute instance i's draws with no shared stream — the bitwise-
        identical-for-any-worker-count property.  ``salt`` separates the
        affine/crop/mirror stream (0) from contrast/illumination (91),
        mirroring the serial path's two seeds."""
        return np.random.RandomState(
            (self.seed_data + salt + (i + 1) * 2654435761) % (2 ** 31))

    def _sharded_thunks(self):
        """The pooled submission stream: ``(global_index, thunk)`` pairs,
        elastic-sharded to this host.  The enumeration stays GLOBAL so
        the per-instance RNG — and hence the emitted bytes — for
        instance i are identical no matter how many hosts split the
        stream; a skipped thunk costs nothing (decode rides inside)."""
        hosts, rank = self.elastic_hosts, self.elastic_rank
        if hosts <= 1:
            yield from enumerate(self.base.iter_thunks())
            return
        for i, thunk in enumerate(self.base.iter_thunks()):
            if i % hosts == rank:
                yield i, thunk

    def _iter_pooled(self):
        """nworker path: decode thunks from the source fan across an
        order-preserving pool together with this stage's augmentation;
        per-stage wall times flow to ``pipeline_stats()``."""
        from ..utils.parallel_pool import OrderedWorkerPool
        dev_norm = self._device_norm_active()
        stats = self._stats
        pool = OrderedWorkerPool(self.nworker, stats=stats, name='pool')

        def job(task):
            i, thunk = task
            t0 = time.perf_counter()
            inst = thunk()                      # source decode (deferred)
            t1 = time.perf_counter()
            crop = self._process_raw(inst.data, self._inst_rng(i, 0))
            if dev_norm:
                out = DataInst(inst.index, np.ascontiguousarray(crop),
                               inst.label, inst.extra_data)
            else:
                out = self._finish_host(inst, crop, self._inst_rng(i, 91))
            if stats is not None:
                t2 = time.perf_counter()
                stats.observe('decode_ms', (t1 - t0) * 1e3)
                stats.observe('augment_ms', (t2 - t1) * 1e3)
            return out

        yield from pool.imap(job, self._sharded_thunks())

    def __iter__(self):
        if self.nworker:
            yield from self._iter_pooled()
            return
        if self.elastic_hosts > 1:
            raise ValueError(
                'elastic_hosts > 1 requires the pooled path (nworker >= '
                '1): the serial stream draws from one shared sequential '
                'RNG, which cannot shard per host and stay bitwise '
                'reconstructable')
        if self._device_norm_active():
            # raw crops go to the device untouched; the net normalizes
            # them there (nnet/net.py _input_to_device_layout)
            for inst, crop in self._raw_iter():
                yield DataInst(inst.index, np.ascontiguousarray(crop),
                               inst.label, inst.extra_data)
            return
        rng = np.random.RandomState(self.seed_data + 91)
        for inst, crop in self._raw_iter():
            yield self._finish_host(inst, crop, rng)

    def _create_mean_img(self):
        if self.silent == 0:
            print(f'cannot find {self.name_meanimg}: create mean image, '
                  f'this will take some time...')
        start = time.monotonic()
        mean = None
        cnt = 0
        for _, crop in self._raw_iter():
            mean = crop.astype(np.float64) if mean is None else mean + crop
            cnt += 1
            if cnt % 1000 == 0 and self.silent == 0:
                print(f'[{cnt:8d}] images processed, '
                      f'{int(time.monotonic() - start)} sec elapsed')
        if cnt == 0:
            raise RuntimeError('input iterator failed.')
        self._meanimg = (mean / cnt).astype(np.float32)
        _save_mean(self.name_meanimg, self._meanimg)
        if self.silent == 0:
            print(f'save mean image to {self.name_meanimg}..')


def _save_mean(path: str, img: np.ndarray) -> None:
    """(ndim, shape, float32 data) — mshadow SaveBinary convention."""
    with open(path, 'wb') as f:
        f.write(struct.pack('<I', img.ndim))
        f.write(struct.pack(f'<{img.ndim}I', *img.shape))
        f.write(np.ascontiguousarray(img, np.float32).tobytes())


def _load_mean(path: str) -> np.ndarray:
    with open(path, 'rb') as f:
        (ndim,) = struct.unpack('<I', f.read(4))
        shape = struct.unpack(f'<{ndim}I', f.read(4 * ndim))
        data = np.frombuffer(f.read(), np.float32)
    return data[:int(np.prod(shape))].reshape(shape).copy()
