"""Small shared utilities (the part of plant3dvision_tpu/utils.py that the
port's runtime uses)."""

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
