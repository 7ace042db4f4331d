"""Synthetic Voronoi texture images for virtual-scanner backgrounds (port of
bin/voronoi_texture_generator; role of reference
bin/voronoi_texture_generator):

    python -m plant3dvision_tpu_torch.tools.voronoi_texture_generator \\
        [--width 1024] [--height 1024] [--cells 200] [--count 1] [--gray] \\
        [--out voronoi]

Image i is `voronoi_texture(width, height, cells, seed=i)`, written to
`<out>.png` (or `<out>_<i:03d>.png` when --count > 1).
"""

from __future__ import annotations

import argparse

import numpy as np


def voronoi_texture(width, height, n_cells=200, seed=0, colored=True):
    rng = np.random.default_rng(seed)
    pts = rng.random((n_cells, 2)) * [width, height]
    colors = (rng.random((n_cells, 3)) * 255).astype(np.uint8) if colored \
        else np.tile(rng.integers(0, 256, (n_cells, 1), dtype=np.uint8), (1, 3))
    from scipy.spatial import cKDTree
    yy, xx = np.mgrid[0:height, 0:width]
    _, idx = cKDTree(pts).query(np.stack([xx.ravel(), yy.ravel()], axis=1))
    return colors[idx].reshape(height, width, 3)


def main(argv=None):
    from . import write_image

    ap = argparse.ArgumentParser(prog="voronoi_texture_generator")
    ap.add_argument("--width", type=int, default=1024)
    ap.add_argument("--height", type=int, default=1024)
    ap.add_argument("--cells", type=int, default=200)
    ap.add_argument("--count", type=int, default=1)
    ap.add_argument("--gray", action="store_true")
    ap.add_argument("--out", default="voronoi")
    args = ap.parse_args(argv)

    for i in range(args.count):
        img = voronoi_texture(args.width, args.height, args.cells, seed=i,
                              colored=not args.gray)
        path = f"{args.out}_{i:03d}.png" if args.count > 1 else f"{args.out}.png"
        write_image(path, img)
        print(f"wrote {path}")


if __name__ == "__main__":
    main()
