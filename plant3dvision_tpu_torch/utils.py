"""Small shared utilities (the part of plant3dvision_tpu/utils.py that the
port uses: the runtime's prompt and Undistorted's fileset lookup)."""

from __future__ import annotations


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
