"""Streaming imgbin source (``iter = imgbin_stream``): tail an APPENDABLE
``.bin``/``.lst`` pair instead of snapshotting it.

The port's own copy of ``cxxnet_tpu/io/iter_stream.py``.  The
train-while-serve pipeline (``online/``) ingests data that keeps
arriving: a producer appends complete ``BinaryPage`` records to the
``.bin`` and their ``index \\t labels \\t name`` lines to the ``.lst``
(:func:`append_records` is the writer's helper, with the commit order
the reader relies on — lines first, then the page).  This source reads
the file front to back as plain ``imgbin`` does; when it catches up it
polls for growth (``stream_poll`` seconds between checks) and goes on
into the new tail; a pass ends after ``stream_idle`` seconds with no
growth (``stream_idle = 0``: a snapshot pass, read what is there and
stop at the end).

The contract (``tests/test_torch_stream.py`` holds it against JAX's):

* **bitwise twin** — over the same final bytes the stream yields the
  instance sequence a static ``imgbin`` pass yields, however the file
  grew while it was read (append order IS arrival order; ``shuffle=1``
  is refused: a tail reader cannot permute pages it has not seen);
* **incremental tail** — catching up after growth reads ONLY the new
  pages' headers (``ImageBinIterator._refresh_page_table``) and never
  re-reads or re-decodes a consumed page; with the native reader on,
  the new pages are read by index (``NativePageReader(order=...)``);
* **epoch-absolute indexing** — ``iter_thunks`` (the ``nworker`` pool's
  submission stream) comes from the same page walk as ``__iter__``, so
  the per-instance augmentation draws equal the static source's at any
  worker count;
* **replay-stable** — an append-only file replays the same prefix, so
  supervised recovery may re-wind the stream (``is_replay_stable``).
"""

from __future__ import annotations

import os
import time

from ..utils.io_stream import BinaryPage
from .iter_imbin import ImageBinIterator
from .iter_img import parse_lst_line


def append_records(bin_path: str, lst_path: str, records) -> int:
    """Append ``records`` — an iterable of ``(index, label_or_labels,
    blob)`` — as one or more complete ``BinaryPage``s.  The ``.lst``
    lines are committed first (flushed and fsynced), then the page
    bytes: a reader that sees a page always finds its lines.  Returns
    the number of records appended."""
    records = list(records)
    if not records:
        return 0
    with open(lst_path, 'a') as fl:
        for index, labels, _blob in records:
            try:
                lab = '\t'.join(f'{float(v):g}' for v in labels)
            except TypeError:
                lab = f'{float(labels):g}'
            fl.write(f'{index}\t{lab}\tstream\n')
        fl.flush()
        os.fsync(fl.fileno())
    page = BinaryPage()
    with open(bin_path, 'ab') as fb:
        for _index, _labels, blob in records:
            if not page.push(blob):
                page.save(fb)
                page.clear()
                if not page.push(blob):
                    raise ValueError('append_records: blob larger than '
                                     'a page')
        if page.size:
            page.save(fb)
        fb.flush()
        os.fsync(fb.fileno())
    return len(records)


class ImageBinStreamIterator(ImageBinIterator):
    """Tail one appendable imgbin file (see the module docstring).

    Keys beyond plain ``imgbin`` (``image_list`` / ``image_bin``):

    * ``stream_poll``  — seconds between growth checks once caught up
      (default 0.05);
    * ``stream_idle``  — end the pass after this many seconds with no
      growth; 0 (the default) reads the current snapshot and stops;
    * ``stream_fence`` — end the pass after EXACTLY this many instances,
      waiting out growth as needed (0 = off): a pass length every reader
      of the growing file agrees on, where ``stream_idle`` is each
      observer's own.
    """

    def __init__(self):
        super().__init__()
        self.stream_poll = 0.05
        self.stream_idle = 0.0
        self.stream_fence = 0

    def set_param(self, name, val):
        super().set_param(name, val)
        if name == 'stream_poll':
            self.stream_poll = float(val)
        if name == 'stream_idle':
            self.stream_idle = float(val)
        if name == 'stream_fence':
            self.stream_fence = int(val)

    def init(self):
        if self.conf_prefix:
            raise ValueError('imgbin_stream tails ONE appendable file; '
                             'multi-part image_conf_prefix datasets are '
                             'a static-imgbin feature')
        if self.shuffle:
            raise ValueError(
                'imgbin_stream cannot shuffle: a tail reader cannot '
                'permute pages it has not seen yet — arrival order IS '
                'the stream order (and the bitwise-twin/replay contract '
                'depends on it)')
        if self.dist_num_worker > 1:
            raise ValueError('imgbin_stream does not shard across '
                             'workers yet (single-tail contract)')
        super().init()
        # the .lst tail: the lines parsed so far and the byte offset
        # they end at
        self._lines_buf = []
        self._lst_offset = 0

    def is_replay_stable(self) -> bool:
        # append-only: every pass replays the same prefix in the same
        # order, so supervised recovery may re-wind this stream
        return True

    def _load_lines(self, part):
        """The ``.lst`` twin of :meth:`_refresh_page_table`: only the
        bytes appended since the last read are parsed, and a trailing
        line without its ``\\n`` stays unread until the writer ends it.
        The file is append-only, so the parse accumulated is the
        file's."""
        try:
            with open(self._lists[part], 'rb') as f:
                f.seek(self._lst_offset)
                chunk = f.read()
        except FileNotFoundError:
            return self._lines_buf
        if chunk:
            cut = chunk.rfind(b'\n')
            if cut >= 0:
                text = chunk[:cut + 1].decode()
                self._lst_offset += cut + 1
                self._lines_buf.extend(
                    parse_lst_line(ln) for ln in text.split('\n')
                    if ln.strip())
        return self._lines_buf

    def _await_lines(self, part, need: int):
        """The ``.lst`` lines of the first ``need`` instances.  A page
        seen before its lines (a writer that broke the lines-first
        order) gets a short grace, then fails as the static reader
        does."""
        lines = self._load_lines(part)
        if len(lines) >= need:
            return lines
        budget = max(self.stream_idle, 10 * self.stream_poll)
        deadline = time.monotonic() + budget
        while time.monotonic() < deadline:
            time.sleep(self.stream_poll)
            lines = self._load_lines(part)
            if len(lines) >= need:
                return lines
        raise RuntimeError('imgbin_stream: .lst shorter than .bin '
                           f'contents ({len(lines)} lines < {need} '
                           'instances) — append lines before pages')

    def _epoch_pages(self, rng_page):
        """One streaming pass at page granularity: every complete page on
        disk, then polls for growth until ``stream_idle`` passes with
        none — or, with ``stream_fence``, until exactly that many
        instances were yielded (the last page cut at the fence).  Growth
        reads only the appended pages' headers, and the new pages by
        index: consumed pages are never read again."""
        part = 0
        pidx = 0
        yielded = 0
        fence = self.stream_fence
        idle_since = None
        while True:
            try:
                counts, starts = self._refresh_page_table(part)
            except FileNotFoundError:
                # the writer has not made the file yet: an empty stream,
                # polled like any caught-up tail
                counts, starts = [], [0]
            if pidx < len(counts):
                idle_since = None
                order = list(range(pidx, len(counts)))
                pidx = len(counts)
                for p, blobs in self._page_stream(part, order):
                    if len(blobs) != counts[p]:
                        raise RuntimeError(
                            f'imgbin_stream: page {p} holds {len(blobs)} '
                            f'objects but its header said {counts[p]}')
                    if fence:
                        blobs = blobs[:fence - yielded]
                        if not blobs:
                            return
                    lines = self._await_lines(part, starts[p] + len(blobs))
                    yield blobs, lines[starts[p]:starts[p] + len(blobs)]
                    yielded += len(blobs)
                    if fence and yielded >= fence:
                        return
                continue
            if fence:
                # a fenced pass owes the remaining instances: wait out
                # the writer rather than end early
                time.sleep(self.stream_poll)
                continue
            if self.stream_idle <= 0:
                return
            now = time.monotonic()
            if idle_since is None:
                idle_since = now
            elif now - idle_since >= self.stream_idle:
                return
            time.sleep(self.stream_poll)
