"""Binary-page image sources (``imgbin`` and ``imgbinx``).

The port's own copy of ``cxxnet_tpu/io/iter_imbin.py``.  Reads the
reference's packed image format: a ``.bin`` stream of 64MB
``BinaryPage``s whose objects are encoded (JPEG/PNG) image blobs, paired
record-for-record with a ``.lst`` file carrying ``index \\t labels...``.

``imgbin`` (``src/io/iter_thread_imbin-inl.hpp:16-283``):
* multi-part datasets via ``image_conf_prefix`` printf-style pattern +
  ``image_conf_ids = a-b`` (iter_thread_imbin:225-278),
* distributed worker sharding: parts (or pages, for a single file) are
  round-robin split across workers by ``dist_num_worker`` /
  ``dist_worker_rank`` (``PS_RANK`` env respected, :189-220),
* ``shuffle=1`` randomizes page order, re-seeded each epoch — pages are
  fixed 64MB records, so a single ``.bin`` is random-access by page index.

``imgbinx`` (``src/io/iter_thread_imbin_x-inl.hpp:18-397``): the two-stage
pipeline — a page-loading stage behind a ThreadBuffer feeding a decode
stage behind a second, deeper ThreadBuffer that also randomizes instance
order *within* each page; decode overlaps page IO instead of serializing
behind it.

Pages are read by the port's native C++ reader (``runtime/native.py``:
a prefetching reader thread, seek-based for a page order) when it is
built and the pages are the format's 64 MB, else by ``BinaryPage``;
blobs decode through ``iter_img.decode_image`` (native libjpeg, PIL for
other formats).  ``CXXNET_NO_NATIVE=1`` forces the Python path.
"""


from __future__ import annotations

import collections
import os

import numpy as np

from ..utils.io_stream import BinaryPage
from ..utils.thread_buffer import ThreadBuffer
from .data import DataInst, IIterator
from .iter_img import decode_image, parse_lst_line


def scan_page_table(bin_path: str, start_page: int = 0):
    """Per-page object counts of a ``.bin`` file, read from the page
    headers only (4 bytes at each page boundary) — no payload IO.
    ``start_page`` skips pages already scanned: a grown file's re-scan
    reads only the appended pages' headers.  The file's size is read
    afresh on every call (an appendable file's size holds only for the
    scan that saw it), and only COMPLETE pages are reported: a page the
    writer has not finished is invisible."""
    counts = []
    size = os.path.getsize(bin_path)
    with open(bin_path, 'rb') as f:
        for off in range(start_page * BinaryPage.N_BYTES,
                         size - BinaryPage.N_BYTES + 1, BinaryPage.N_BYTES):
            f.seek(off)
            counts.append(int.from_bytes(f.read(4), 'little'))
    return counts


class ImageBinIterator(IIterator):
    def __init__(self):
        self.path_imglist = ''
        self.path_imgbin = ''
        self.label_width = 1
        self.silent = 0
        self.shuffle = 0
        self.seed_data = 0
        self.conf_prefix = ''
        self.conf_ids = ''
        self.dist_num_worker = 1
        self.dist_worker_rank = 0
        self._lists = []
        self._bins = []

    def set_param(self, name, val):
        if name in ('image_list', 'path_imglist'):
            self.path_imglist = val
        if name in ('image_bin', 'path_imgbin'):
            self.path_imgbin = val
        if name == 'label_width':
            self.label_width = int(val)
        if name == 'silent':
            self.silent = int(val)
        if name == 'shuffle':
            self.shuffle = int(val)
        if name == 'seed_data':
            self.seed_data = int(val)
        if name == 'image_conf_prefix':
            self.conf_prefix = val
        if name == 'image_conf_ids':
            self.conf_ids = val
        if name == 'dist_num_worker':
            self.dist_num_worker = int(val)
        if name == 'dist_worker_rank':
            self.dist_worker_rank = int(val)

    def init(self):
        rank = int(os.environ.get('PS_RANK', self.dist_worker_rank))
        nworker = self.dist_num_worker
        if self.conf_prefix:
            a, _, b = self.conf_ids.partition('-')
            ids = list(range(int(a), int(b or a) + 1))
            # shard whole parts across workers (iter_thread_imbin:196-213)
            ids = ids[rank::nworker] if nworker > 1 else ids
            self._lists = [self.conf_prefix % i + '.lst' for i in ids]
            self._bins = [self.conf_prefix % i + '.bin' for i in ids]
        else:
            if not (self.path_imglist and self.path_imgbin):
                raise ValueError('imgbin: must set image_list and image_bin')
            self._lists = [self.path_imglist]
            self._bins = [self.path_imgbin]
        self._single_shard = (nworker > 1 and not self.conf_prefix,
                              rank, nworker)
        self._epoch = 0
        self._tables: dict = {}
        if self.silent == 0:
            print(f'{type(self).__name__}: {len(self._bins)} part(s), '
                  f'worker {rank}/{nworker}')

    @staticmethod
    def _native():
        """The native reader when it is built and reads this format's
        page size (its pages are the fixed 64 MB of the format), else
        None."""
        from ..runtime import native
        if BinaryPage.N_BYTES != native.PAGE_BYTES \
                or not native.native_available():
            return None
        return native

    def _iter_pages(self, bin_path):
        native = self._native()
        if native is not None:
            reader = native.NativePageReader(bin_path)
            try:
                yield from reader.iter_pages()
            finally:
                reader.close()
            return
        with open(bin_path, 'rb') as f:
            while True:
                page = BinaryPage()
                if not page.load(f):
                    return
                yield list(page)

    def _load_lines(self, part):
        with open(self._lists[part]) as f:
            return [parse_lst_line(l) for l in f if l.strip()]

    def _page_starts(self, part):
        """(counts, starts): per-page object counts and the cumulative
        .lst line offset of each page of this part, cached per part;
        :meth:`_refresh_page_table` extends the cache when the file
        grew."""
        if part not in self._tables:
            counts = scan_page_table(self._bins[part])
            starts = [0]
            for c in counts:
                starts.append(starts[-1] + c)
            self._tables[part] = (counts, starts)
        return self._tables[part]

    def _refresh_page_table(self, part):
        """Extend the cached page table with the pages appended since
        the last scan, reading ONLY their headers: a grown file yields
        its new tail without re-reading (or re-decoding) the pages
        already indexed.  The scan the streaming source polls on."""
        if part not in self._tables:
            return self._page_starts(part)
        counts, starts = self._tables[part]
        for c in scan_page_table(self._bins[part], start_page=len(counts)):
            counts.append(c)
            starts.append(starts[-1] + c)
        return counts, starts

    def _page_stream(self, part, page_order=None):
        """Yield (page_idx, blobs); ``page_order=None`` streams the file
        sequentially, else reads page-by-page in the given order — pages
        are fixed 64MB records, hence random-access."""
        if page_order is None:
            yield from enumerate(self._iter_pages(self._bins[part]))
            return
        page_order = list(page_order)
        native = self._native()
        if native is not None:
            reader = native.NativePageReader(self._bins[part],
                                             order=page_order)
            try:
                for pidx, page in zip(page_order, reader.iter_pages()):
                    yield pidx, page
            finally:
                reader.close()
            return
        with open(self._bins[part], 'rb') as f:
            for pidx in page_order:
                f.seek(pidx * BinaryPage.N_BYTES)
                page = BinaryPage()
                if not page.load(f):
                    raise RuntimeError('imgbin: truncated page '
                                       f'{pidx} in {self._bins[part]}')
                yield pidx, list(page)

    def _make_inst(self, blob, line):
        index, labels, _ = line
        # keep the decoded uint8: the augment stage owns the float32
        # conversion (host path) or defers it to device (device_normalize)
        return DataInst(index, decode_image(blob),
                        labels[:self.label_width]
                        if self.label_width else labels)

    def is_replay_stable(self) -> bool:
        # shuffle=1 draws a fresh permutation per __iter__ (_epoch_rngs
        # bumps the epoch ordinal), so a replayed pass is a different
        # sequence; sequential reads are bit-stable
        return not self.shuffle

    def _epoch_rngs(self):
        """Fresh deterministic RNGs for one epoch pass, seeded from
        (seed_data, epoch ordinal) on the consumer thread — so producer
        prefetch depth or an abandoned pass (round_batch wrap) cannot
        desync later epochs, yet every epoch gets a new permutation.
        Distinct page/instance streams mirror the reference imgbinx's
        kRandMagic=121/111 samplers."""
        e = self._epoch
        self._epoch += 1
        return (np.random.RandomState((self.seed_data + 121 + e * 7919)
                                      % (2 ** 31)),
                np.random.RandomState((self.seed_data + 111 + e * 104729)
                                      % (2 ** 31)))

    def _epoch_pages(self, rng_page):
        """One epoch pass at page granularity: yields ``(blobs,
        lines_slice)`` applying part-order shuffle, page-order shuffle
        within each part (single-file datasets included — the fix for
        ``shuffle=1`` being a no-op there), worker sharding, and .lst
        pairing in one place.  Sharded shuffled passes filter the page
        permutation *before* any IO, so each worker reads only its own
        1/N of the pages."""
        sharded, rank, nworker = self._single_shard
        order = list(range(len(self._bins)))
        if self.shuffle:
            rng_page.shuffle(order)
        for part in order:
            lines = self._load_lines(part)
            if self.shuffle:
                counts, starts = self._page_starts(part)
                if starts[-1] > len(lines):
                    raise RuntimeError('imgbin: .lst shorter than .bin '
                                       'contents')
                page_order = [p for p in rng_page.permutation(len(counts))
                              if not sharded or p % nworker == rank]
                for pidx, blobs in self._page_stream(part, page_order):
                    base = starts[pidx]
                    yield blobs, lines[base:base + len(blobs)]
            elif sharded:
                # unshuffled but sharded: seek past non-owned pages instead
                # of reading and discarding them (1/N of the IO per worker)
                counts, starts = self._page_starts(part)
                if starts[-1] > len(lines):
                    raise RuntimeError('imgbin: .lst shorter than .bin '
                                       'contents')
                owned = [p for p in range(len(counts))
                         if p % nworker == rank]
                for pidx, blobs in self._page_stream(part, owned):
                    yield blobs, lines[starts[pidx]:
                                       starts[pidx] + len(blobs)]
            else:
                base = 0
                for pidx, blobs in self._page_stream(part):
                    if base + len(blobs) > len(lines):
                        raise RuntimeError('imgbin: .lst shorter than .bin '
                                           'contents')
                    yield blobs, lines[base:base + len(blobs)]
                    base += len(blobs)

    def __iter__(self):
        # defined over iter_thunks so the serial and pooled paths can
        # never disagree on instance order (the pool's bitwise-identity
        # contract, io/data.py)
        for thunk in self.iter_thunks():
            yield thunk()

    def iter_thunks(self):
        """Parallel-pool submission stream (``io/data.py``) — and the
        single definition of this source's instance order (``__iter__``
        derives from it).  Each thunk carries the ENCODED blob and
        defers the JPEG decode onto whichever thread runs it — the
        stage the reference pinned to one thread
        (``iter_thread_imbin-inl.hpp``)."""
        rng_page, _ = self._epoch_rngs()
        for blobs, lines in self._epoch_pages(rng_page):
            for blob, line in zip(blobs, lines):
                yield (lambda b=blob, li=line: self._make_inst(b, li))


class ImageBinXIterator(ImageBinIterator):
    """Two-stage imgbinx pipeline (``iter_thread_imbin_x-inl.hpp:18-397``):
    the page stage (``_epoch_pages``) runs behind a ThreadBuffer feeding a
    decode stage behind a second, deeper ThreadBuffer.  ``shuffle=1``
    randomizes part order, page order within each part, and instance order
    *within* each page — the reference's SGD-quality shuffle for datasets
    too big to permute globally — while decode overlaps page IO instead of
    serializing behind it (buffer depths 2 pages / 256 instances,
    reference :22-23).

    Beyond the reference's single decode thread: the decode stage is a
    bounded, ORDER-PRESERVING thread pool (``decode_threads``, default
    min(8, cores); env ``CXXNET_DECODE_THREADS`` overrides).  PIL's
    decoders release the GIL, so the pool scales the supply side with the
    host's cores.  Results are yielded strictly in submission order, so
    epoch instance order is bitwise identical to the serial path for any
    thread count."""

    PAGE_BUFFER = 2
    INST_BUFFER = 256

    def __init__(self):
        super().__init__()
        raw = os.environ.get('CXXNET_DECODE_THREADS', '').strip()
        auto = min(8, os.cpu_count() or 1)
        if raw:
            try:
                self.decode_threads = max(1, int(raw))   # 0 -> serial
            except ValueError:
                self.decode_threads = auto               # junk -> auto
        else:
            self.decode_threads = auto

    def set_param(self, name, val):
        super().set_param(name, val)
        if name == 'decode_threads':
            self.decode_threads = max(1, int(val))

    def __iter__(self):
        rng_page, rng_inst = self._epoch_rngs()

        def insts():
            from concurrent.futures import ThreadPoolExecutor
            window = self.decode_threads * 4
            with ThreadPoolExecutor(self.decode_threads) as pool:
                pending = collections.deque()
                for blobs, lines in ThreadBuffer(
                        lambda: self._epoch_pages(rng_page),
                        self.PAGE_BUFFER):
                    inst_order = (rng_inst.permutation(len(blobs))
                                  if self.shuffle else range(len(blobs)))
                    for k in inst_order:
                        pending.append(pool.submit(
                            self._make_inst, blobs[k], lines[k]))
                        while len(pending) > window:
                            yield pending.popleft().result()
                while pending:
                    yield pending.popleft().result()

        return iter(ThreadBuffer(insts, self.INST_BUFFER))

    def iter_thunks(self):
        """imgbinx submission stream: page reads stay behind their own
        ThreadBuffer (IO overlaps the pool) and ``shuffle=1`` keeps the
        within-page instance shuffle; the decode itself rides the thunk
        — the chain-level ``nworker`` pool replaces this class's private
        decode pool, never stacks on it."""
        rng_page, rng_inst = self._epoch_rngs()
        for blobs, lines in ThreadBuffer(
                lambda: self._epoch_pages(rng_page), self.PAGE_BUFFER):
            inst_order = (rng_inst.permutation(len(blobs))
                          if self.shuffle else range(len(blobs)))
            for k in inst_order:
                yield (lambda b=blobs[k], li=lines[k]:
                       self._make_inst(b, li))
