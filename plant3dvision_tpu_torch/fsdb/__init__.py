"""Filesystem database (L0 storage layer).

Plantdb-compatible on-disk format (reference: plantdb submodule API,
reconstructed from call sites; see the reference's layout of
tests/testdata/real_plant):

    <db>/romidb                          # marker file
    <db>/<scan>/files.json               # manifest {"filesets":[{"id",...,"files":[{"id","file"}]}]}
    <db>/<scan>/<fileset>/<file.ext>     # payloads
    <db>/<scan>/metadata/metadata.json   # scan metadata
    <db>/<scan>/metadata/<fileset>.json  # fileset metadata
    <db>/<scan>/metadata/<fileset>/<file_id>.json  # file metadata
"""

from .db import FSDB, Scan, Fileset, File, DBError
from . import io

__all__ = ["FSDB", "Scan", "Fileset", "File", "DBError", "io"]
