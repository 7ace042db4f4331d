"""Validate a scan's manual measures.json (port of bin/check_measures; role
of reference bin/check_measures): sequence lengths, angle units,
plausibility.

    python -m plant3dvision_tpu_torch.tools.check_measures <db>/<scan>

Prints the report and exits 0 when the measures are valid, 1 otherwise.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np


def main(argv=None):
    from ..utils import is_radians

    ap = argparse.ArgumentParser(prog="check_measures")
    ap.add_argument("dataset", help="path to the scan directory")
    args = ap.parse_args(argv)

    path = Path(args.dataset) / "measures.json"
    if not path.exists():
        print(f"FAIL: no measures.json in {args.dataset}")
        sys.exit(1)
    m = json.load(open(path))
    angles = m.get("angles", [])
    internodes = m.get("internodes", [])
    ok = True
    if not angles:
        print("FAIL: no angles")
        ok = False
    if len(angles) != len(internodes):
        print(f"WARN: len(angles)={len(angles)} != len(internodes)={len(internodes)}")
    unit = "radians" if is_radians(angles) else "degrees"
    print(f"angles: n={len(angles)}, unit(guess)={unit}, "
          f"mean={np.mean(angles):.3f}, range=[{min(angles):.3f}, {max(angles):.3f}]")
    deg = np.degrees(angles) if unit == "radians" else np.asarray(angles)
    weird = np.sum((deg < 10) | (deg > 350))
    if weird:
        print(f"WARN: {weird} angle(s) near 0/360 deg")
    if internodes:
        neg = np.sum(np.asarray(internodes) < 0)
        if neg:
            print(f"FAIL: {neg} negative internodes")
            ok = False
        print(f"internodes: n={len(internodes)}, mean={np.mean(internodes):.2f}")
    print("OK" if ok else "INVALID")
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
