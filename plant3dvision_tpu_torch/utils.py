"""Small shared utilities (the part of plant3dvision_tpu/utils.py that the
port uses: the runtime's prompt, the task filesets' lookup and
ExtrinsicCalibration's circle fit and figure)."""

from __future__ import annotations

import numpy as np


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
