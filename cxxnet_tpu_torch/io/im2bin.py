"""im2bin — pack images listed in a .lst file into a BinaryPage stream.

The port's twin of ``tools/im2bin.py`` (the reference packer,
``tools/im2bin.cpp``), byte for byte: each image file's raw encoded
bytes become one object in a sequence of 64MB pages, in .lst order, so
the ``imgbin`` iterator can pair them with the list.

Usage: python -m cxxnet_tpu_torch.io.im2bin image.lst image_root out.bin
"""

import os
import sys

from ..utils.io_stream import BinaryPage
from .iter_img import parse_lst_line


def main(argv):
    if len(argv) != 3:
        print(__doc__)
        return 1
    lst_path, root, out_path = argv
    page = BinaryPage()
    n = 0
    with open(out_path, 'wb') as fo, open(lst_path) as fl:
        for line in fl:
            if not line.strip():
                continue
            _, _, fname = parse_lst_line(line)
            with open(os.path.join(root, fname) if root != '.' else fname,
                      'rb') as fi:
                blob = fi.read()
            if not page.push(blob):
                page.save(fo)
                page.clear()
                if not page.push(blob):
                    raise ValueError(f'image larger than a page: {fname}')
            n += 1
            if n % 1000 == 0:
                print(f'{n} images packed')
        if page.size:
            page.save(fo)
    print(f'packed {n} images into {out_path}')
    return 0


if __name__ == '__main__':
    sys.exit(main(sys.argv[1:]))
