"""Task runtime (L1): config-wired DAG runner with fileset-existence
completeness and param-hashed output filesets.

Re-implements the semantics of the reference's `romitask` submodule (luigi
based; API reconstructed from call sites, see SURVEY.md §2.3): `RomiTask`,
`FileByFileTask`, `FilesetTarget`, marker tasks, `Clean`, the
`romi_run_task <Task> <dataset> --config <toml>` CLI — without luigi.
"""

from .task import (
    RomiTask,
    FileByFileTask,
    FilesetTarget,
    Parameter,
    TaskRegistry,
    ImagesFilesetExists,
    ModelFilesetExists,
    FilesetExists,
    DatasetExists,
    VirtualPlantObj,
    DummyTask,
    Clean,
)
from .config import RunContext
from .runner import run_task

__all__ = [
    "RomiTask", "FileByFileTask", "FilesetTarget", "Parameter", "TaskRegistry",
    "ImagesFilesetExists", "ModelFilesetExists", "FilesetExists", "DatasetExists",
    "VirtualPlantObj", "DummyTask", "Clean", "RunContext", "run_task",
]
