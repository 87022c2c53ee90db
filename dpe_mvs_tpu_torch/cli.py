"""CLI with the reference's positional-argument contract (main.cpp:602-635):

    python -m dpe_mvs_tpu_torch.cli <dense_folder> [gpu_index] [verbose]
        [viz] [fusion] [depth] [normal] [weak] [edge]
"""
from __future__ import annotations

import sys


def _flag(argv, i, default):
    if len(argv) > i:
        return bool(int(argv[i]))
    return default


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        print("USAGE: python -m dpe_mvs_tpu_torch.cli dense_folder "
              "[gpu_index] [verbose] [viz] [fusion] [depth] [normal] [weak] "
              "[edge]", file=sys.stderr)
        return 1
    dense_folder = argv[0]
    gpu_index = int(argv[1]) if len(argv) > 1 else 0
    verbose = _flag(argv, 2, True)
    viz = _flag(argv, 3, False)
    fusion = _flag(argv, 4, False)
    depth = _flag(argv, 5, True)
    normal = _flag(argv, 6, False)
    weak = _flag(argv, 7, False)
    edge = _flag(argv, 8, False)

    from .api import dpe_mvs
    return dpe_mvs(dense_folder, gpu_index, verbose, fusion, viz, depth,
                   normal, weak, edge)


if __name__ == "__main__":
    sys.exit(main())
