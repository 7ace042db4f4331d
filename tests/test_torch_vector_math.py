"""The port's CPU path gives the same bits in every process.

MKL's vector math library, behind torch's CPU sqrt, exp, log, ... of float
tensors, sets up its dispatch at its first call. When that first call
comes from the threads of one parallel region at once, a thread can
compute its share with a coarse kernel (sqrt(1.0) = 0.99975586), which
moved the signed distance, the point cloud and the angles of the
geometric chain in about one fresh process in ten on a loaded machine.
The package makes one call from the importing thread first
(plant3dvision_tpu_torch/__init__.py). These tests hold that call in
place, and run the signed distance's plain version as the first vector
math of several fresh processes at once, each on several threads on a
machine they load together.
"""

import hashlib
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent

_FIRST_CALLS = r"""
import threading, torch
calls = []
sqrt = torch.sqrt
def spy(x, *a, **k):
    calls.append((x.numel(), str(x.dtype), threading.current_thread() is
                  threading.main_thread()))
    return sqrt(x, *a, **k)
torch.sqrt = spy
import plant3dvision_tpu_torch
print(calls)
"""

_WORKER = r"""
import hashlib, sys
import numpy as np
import torch
from plant3dvision_tpu_torch.ops.edt import signed_distance_plain
torch.set_num_threads(4)
vol = torch.from_numpy(np.load(sys.argv[1]))
d = signed_distance_plain(vol, 20)
print(hashlib.md5(d.numpy().tobytes()).hexdigest())
"""


def _volume():
    """A stem and a few ellipsoid organs on the mini chain's grid (43 x 43
    x 104), float32 0 / 1."""
    x, y, z = np.meshgrid(np.arange(43), np.arange(43), np.arange(104),
                          indexing="ij")
    vol = ((x - 21) ** 2 + (y - 21) ** 2 <= 4) & (z >= 4) & (z < 100)
    for k, (cx, cy, cz) in enumerate([(30, 21, 30), (12, 25, 55),
                                      (21, 33, 80)]):
        vol |= ((x - cx) / 5.0) ** 2 + ((y - cy) / 3.0) ** 2 + \
            ((z - cz) / (4.0 + k)) ** 2 <= 1
    return vol.astype(np.float32)


def test_vector_math_is_set_up_at_import_before_any_port_code():
    """A fresh process importing the package calls torch.sqrt first on a
    float32 and a float64 tensor of 8 elements (too small to split over
    threads), from the importing thread."""
    out = subprocess.run([sys.executable, "-c", _FIRST_CALLS], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         check=True).stdout.strip().splitlines()[-1]
    assert out == str([(8, "torch.float32", True), (8, "torch.float64",
                                                   True)])


def test_signed_distance_is_the_same_in_concurrent_fresh_processes(tmp_path):
    """8 fresh processes at once, each on 4 threads, whose first vector
    math is the signed distance of the same volume (cap 20): every one
    gives the bits of this process's signed distance. (Without the call
    at import, this test failed in 6 of 10 runs on an 8-core machine.)"""
    from plant3dvision_tpu_torch.ops.edt import signed_distance_plain
    vol = _volume()
    path = tmp_path / "vol.npy"
    np.save(path, vol)
    want = signed_distance_plain(torch.from_numpy(vol), 20).numpy()
    assert (want == 0.5).any()          # sqrt(1) - 0.5 among the values
    want = hashlib.md5(want.tobytes()).hexdigest()

    def run(_):
        return subprocess.run([sys.executable, "-c", _WORKER, str(path)],
                              cwd=ROOT, capture_output=True, text=True,
                              timeout=300, check=True).stdout.strip()
    with ThreadPoolExecutor(8) as ex:
        got = list(ex.map(run, range(8)))
    assert got == [want] * 8
