"""Generate a ChArUco board image (port of bin/create_charuco_board; role
of reference bin/create_charuco_board; needs cv2 with aruco):

    python -m plant3dvision_tpu_torch.tools.create_charuco_board \\
        [--n_squares_x 14] [--n_squares_y 10] [--square_length 2.0] \\
        [--marker_length 1.5] [--aruco_pattern DICT_4X4_1000] \\
        [--width 1400] [--height 1000] [--out charuco_board.png]
"""

from __future__ import annotations

import argparse


def main(argv=None):
    from ..calibration import create_charuco_image, get_charuco_board
    from . import write_image

    ap = argparse.ArgumentParser(prog="create_charuco_board")
    ap.add_argument("--n_squares_x", type=int, default=14)
    ap.add_argument("--n_squares_y", type=int, default=10)
    ap.add_argument("--square_length", type=float, default=2.0)
    ap.add_argument("--marker_length", type=float, default=1.5)
    ap.add_argument("--aruco_pattern", default="DICT_4X4_1000")
    ap.add_argument("--width", type=int, default=1400)
    ap.add_argument("--height", type=int, default=1000)
    ap.add_argument("--out", default="charuco_board.png")
    args = ap.parse_args(argv)

    board = get_charuco_board(args.n_squares_x, args.n_squares_y,
                              args.square_length, args.marker_length,
                              args.aruco_pattern)
    img = create_charuco_image(board, args.width, args.height)
    write_image(args.out, img)
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
