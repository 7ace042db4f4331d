"""Small shared utilities (port of plant3dvision_tpu/utils.py: the
runtime's prompt, the task filesets' lookup, ExtrinsicCalibration's circle
fit and figure, and the evaluation's JSON and measures helpers)."""

from __future__ import annotations

import numpy as np


def flatten(nested):
    """Flatten arbitrarily nested lists/tuples into a flat list."""
    out = []
    for x in nested:
        if isinstance(x, (list, tuple)):
            out.extend(flatten(x))
        else:
            out.append(x)
    return out


def jsonify(obj):
    """Recursively convert numpy containers to JSON-serializable types."""
    if isinstance(obj, dict):
        return {k: jsonify(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [jsonify(v) for v in obj]
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if isinstance(obj, np.generic):
        return obj.item()
    return obj


def auto_format_bytes(n_bytes: int) -> str:
    units = ["B", "KB", "MB", "GB", "TB"]
    v = float(n_bytes)
    for u in units:
        if v < 1024 or u == units[-1]:
            return f"{v:.2f} {u}" if u != "B" else f"{int(v)} B"
        v /= 1024.0
    return f"{v:.2f} TB"


def yes_no_choice(question: str, default: bool = False) -> bool:
    suffix = " [Y/n] " if default else " [y/N] "
    try:
        ans = input(question + suffix).strip().lower()
    except EOFError:
        return default
    if not ans:
        return default
    return ans in ("y", "yes")


def locate_task_filesets(scan, task_names):
    """Map task name -> fileset id by prefix match (reference utils.py:212).

    Fileset ids are '{TaskName}_{slug}_{hash}'; pick the first fileset whose
    id starts with '{TaskName}_' (or equals the task name).
    """
    out = {}
    fs_ids = scan.list_filesets()
    for name in task_names:
        match = "None"
        for fs_id in fs_ids:
            if fs_id == name or fs_id.startswith(name + "_"):
                match = fs_id
                break
        out[name] = match
    return out


def fit_circle(x, y):
    """Least-squares circle fit. Returns (xc, yc, radius, residuals).

    Role of reference utils.py:132 (used by ExtrinsicCalibration to check the
    turntable camera path is circular).
    """
    x = np.asarray(x, dtype=float)
    y = np.asarray(y, dtype=float)
    A = np.stack([x, y, np.ones_like(x)], axis=1)
    b = x ** 2 + y ** 2
    sol, *_ = np.linalg.lstsq(A, b, rcond=None)
    xc, yc = sol[0] / 2.0, sol[1] / 2.0
    r = np.sqrt(sol[2] + xc ** 2 + yc ** 2)
    residuals = np.sqrt((x - xc) ** 2 + (y - yc) ** 2) - r
    return xc, yc, r, residuals


def plot_points_circle(x, y, cx, cy, r, figname=None):
    """Scatter of 2D points + the fitted circle, saved to `figname`
    (role of reference utils.py plot_points_circle — the visual companion
    of fit_circle in the ExtrinsicCalibration QC). Needs matplotlib."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots()
    ax.scatter(np.asarray(x, float), np.asarray(y, float), marker="x",
               c="red", label="camera positions")
    ax.add_artist(plt.Circle((cx, cy), radius=r, fill=False))
    ax.set_aspect("equal")
    ax.set_xlabel("X (mm)")
    ax.set_ylabel("Y (mm)")
    ax.legend(loc="upper right", fontsize=8)
    if figname is not None:
        fig.savefig(figname, dpi=100, bbox_inches="tight")
        plt.close(fig)
        return None
    return fig


def is_radians(values) -> bool:
    """Heuristic: a sequence of angles is in radians if its mean magnitude is
    < pi-ish (reference utils.py:225 — used to auto-convert measures.json)."""
    values = np.abs(np.asarray(values, dtype=float))
    if len(values) == 0:
        return False
    return float(np.nanmean(values)) <= 2 * np.pi


def read_measures(scan):
    """Read the manual measurements file shipped with a scan (measures.json)."""
    import json
    path = scan.path() / "measures.json"
    if not path.exists():
        return {}
    with open(path) as f:
        return json.load(f)
