"""Run context: database + scan + TOML config binding.

The reference binds TOML sections to luigi task parameters
(configs/geom_pipe_real.toml + romitask DatabaseConfig). Here a RunContext
owns the FSDB connection, the active scan and the parsed config, and hands
out singleton task instances (one per task class per run, since parameters
are config-determined).
"""

from __future__ import annotations

import json

from ..fsdb import FSDB


def load_toml(path) -> dict:
    import tomllib
    with open(path, "rb") as f:
        return tomllib.load(f)


def _toml_scalar(v):
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, (int, float)):
        return repr(v)
    if isinstance(v, (list, tuple)):
        return "[" + ", ".join(_toml_scalar(x) for x in v) + "]"
    # JSON string escaping is a subset of TOML basic-string escaping
    return json.dumps(str(v))


def dump_toml(cfg: dict, _prefix: str = "") -> str:
    """Minimal TOML emitter for pipeline configs (dict sections of
    scalars/lists/nested dicts; None values are dropped — TOML has no
    null). Round-trips through tomllib; used for the per-scan
    `pipeline.toml` config backup the reference's romitask CLI writes
    (read back by tasks/colmap.check_colmap_cfg)."""
    lines, subsections = [], []
    for k, v in cfg.items():
        if v is None:
            continue
        if isinstance(v, dict):
            subsections.append((f"{_prefix}{k}", v))
        else:
            lines.append(f"{k} = {_toml_scalar(v)}")
    out = "\n".join(lines)
    for name, sub in subsections:
        body = dump_toml(sub, _prefix=f"{name}.")
        out += f"\n\n[{name}]\n{body}" if body.strip() else f"\n\n[{name}]"
    return out.lstrip("\n") + ("\n" if not out.endswith("\n") else "")


def resolve_device(device="cuda"):
    """`torch.device` for a run; asking for CUDA without a card raises
    (there is no silent fall back to the CPU)."""
    import torch

    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' was asked for but torch.cuda.is_available() is "
            "False; pass device='cpu' to run on the CPU")
    return device


class RunContext:
    """`device` is where the tasks put their tensors: the card by default,
    the CPU only when the caller asks for it.

    `ranks` is the number of ranks the multi-device lanes may use (the
    counterpart of `len(jax.devices())`): by default one a card on the
    card, one on the CPU. A lane whose JAX condition is "more than one
    device" (`engine="sharded"`, `data_parallel`) shards when it is above
    1. Its mesh (parallel/mesh.py, axis "dp") is started at first use with
    `backend` (by default "nccl" on the card, "gloo" on the CPU; ranks
    that share a card need "gloo") and lives until `close()`; a `mesh`
    given here is used instead, and its size is the rank count."""

    def __init__(self, db: FSDB, scan_id: str, config: dict | None = None,
                 device="cuda", ranks: int | None = None,
                 backend: str | None = None, mesh=None):
        from ..parallel.mesh import default_ranks

        self.device = resolve_device(device)
        self.db = db
        self.scan = db.get_scan(scan_id, create=True)
        self.config = config or {}
        self._tasks: dict[str, object] = {}
        self.ranks = (mesh.size if mesh is not None else int(ranks)
                      if ranks is not None else default_ranks(self.device))
        self.backend = backend
        self._mesh = mesh
        self._own_mesh = False

    def mesh(self):
        """The run's mesh of `ranks` ranks on axis "dp" (started once)."""
        if self._mesh is None:
            from ..parallel.mesh import make_mesh
            self._mesh = make_mesh({"dp": self.ranks}, device=self.device,
                                   backend=self.backend)
            self._own_mesh = True
        return self._mesh

    def close(self):
        """Stop the mesh this context started, if any."""
        if self._own_mesh and self._mesh is not None:
            self._mesh.close()
        self._mesh, self._own_mesh = None, False

    @classmethod
    def from_paths(cls, db_path, scan_id, config_path=None, unsafe=True,
                   device="cuda", ranks=None, backend=None):
        db = FSDB(db_path)
        db.connect(unsafe=unsafe)
        config = load_toml(config_path) if config_path else {}
        return cls(db, scan_id, config, device=device, ranks=ranks,
                   backend=backend)

    def task_config(self, task_name: str) -> dict:
        cfg = dict(self.config.get(task_name, {}))
        # JSON-encoded string params (reference TOML style, e.g.
        # query = "{\"channel\":\"rgb\"}" in geom_pipe_real.toml) are decoded.
        for k, v in list(cfg.items()):
            if isinstance(v, str) and v[:1] in "[{":
                try:
                    cfg[k] = json.loads(v)
                except (json.JSONDecodeError, ValueError):
                    pass
        return cfg

    def get_task(self, name_or_cls):
        """Instantiate (once) a task by registry name or class."""
        from .task import TaskRegistry
        if isinstance(name_or_cls, str):
            cls = TaskRegistry.get(name_or_cls)
        else:
            cls = name_or_cls
        key = cls.__name__
        if key not in self._tasks:
            self._tasks[key] = cls(ctx=self)
        return self._tasks[key]
