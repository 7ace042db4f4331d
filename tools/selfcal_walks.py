#!/usr/bin/env python3
"""Where K12's and K11b's walks go on `chip_smoke.py` phase 12's launches,
counted on the CPU with the plain versions' arithmetic.

The scene is `tools/selfcal_ab.py`'s (phase 11's plant, seeded), each
population cut to its first `--candidates` candidates. For each K12
launch: the valid rays that meet the grid, those that miss the hull (they
walk every step), the steps of the sequential walk (the bound's count,
`ray_coverage_counts_plain(count_work=True)`), those of them that lie in
the alive voxels' box, and those of the range [kf, ke) the kernel walks
(its estimate and proof, repeated here in float32), asserting that the
range loses no hit and that the counts equal the plain version's. For each
K11b launch: the voxel-view tests a voxel makes in the ring's order (the
bound's count) and in the kernel's spread order (k -> k s mod V).

    python tools/selfcal_walks.py --candidates 8
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))


def k12_walks(cargs, counts):
    """The walk's counts of one K12 launch (see the docstring)."""
    from plant3dvision_tpu_torch.ops import selfcal
    from plant3dvision_tpu_torch.ops.carving import fma_f32
    cams, vol_of, view_of, alive, uv, ok, origin, vs, shape, S = cargs
    o, hi = (torch.from_numpy(a) for a in selfcal._box(origin, vs, shape))
    vs_t, n3 = torch.tensor(np.float32(vs)), torch.tensor(shape)
    N = ok.shape[1]
    steps = (torch.arange(S, dtype=torch.float32) + 0.5) * torch.tensor(
        np.float32(1.0) / np.float32(S))
    flat = alive.reshape(alive.shape[0], -1)
    strides = torch.tensor([shape[1] * shape[2], shape[2], 1])
    boxes = []
    for a in alive:
        idx = torch.nonzero(a)
        boxes.append(torch.cat([idx.min(0).values, idx.max(0).values])
                     if len(idx) else torch.tensor([*shape, -1, -1, -1]))
    boxes = torch.stack(boxes).float()
    tiny = torch.tensor(np.float32(1e-12))
    out = dict(rays=0, miss_hull=0, steps=0, steps_in_box=0, steps_range=0)
    cov = []
    chunk = max(1, (1 << 21) // (N * S))
    for g0 in range(0, cams.shape[0], chunk):
        c, vo = cams[g0:g0 + chunk], vol_of[g0:g0 + chunk].long()
        so = view_of[g0:g0 + chunk].long()
        R, tv = c[:, 4:13].reshape(-1, 3, 3), c[:, 13:16]
        cein = fma_f32(R[:, 2], tv[:, 2:3], fma_f32(
            R[:, 1], tv[:, 1:2], R[:, 0] * tv[:, 0:1]))
        dc0 = (uv[so][..., 0] - c[:, 2:3]) / c[:, 0:1]
        dc1 = (uv[so][..., 1] - c[:, 3:4]) / c[:, 1:2]
        d = torch.where(
            selfcal._vector_lanes(N, "cpu")[:, None],
            (R[:, None, 0] * dc0[..., None] + R[:, None, 1] * dc1[..., None])
            + R[:, None, 2],
            R[:, None, 2] + fma_f32(R[:, None, 1], dc1[..., None],
                                    R[:, None, 0] * dc0[..., None]))
        inv = 1.0 / torch.where(d.abs() < tiny, tiny, d)
        ta, tb = (o + cein)[:, None] * inv, (hi + cein)[:, None] * inv
        t0 = torch.minimum(ta, tb).amax(-1).clamp(min=0.0)
        t1 = torch.maximum(ta, tb).amin(-1)
        ts = fma_f32((t1 - t0)[..., None], steps, t0[..., None])
        q = torch.floor((fma_f32(d[:, :, None, :], ts[..., None],
                                 -cein[:, None, None, :]) - o) / vs_t)
        inb = ((q >= 0) & (q < n3)).all(-1)
        hit = flat[vo[:, None, None],
                   (torch.where(inb[..., None], q, 0).long()
                    * strides).sum(-1)] & inb
        lo, hb = boxes[vo][:, None, :3], boxes[vo][:, None, 3:]
        live = (t1 > t0) & ok[so] & (lo[..., 0] <= hb[..., 0])
        first = torch.where(hit.any(-1), hit.int().argmax(-1) + 1, S)
        # the kernel's range: the estimate against the box grown by a voxel
        wl, wh = o + (lo - 1.0) * vs_t, o + (hb + 2.0) * vs_t
        ea, eb = (wl + cein[:, None]) * inv, (wh + cein[:, None]) * inv
        te = torch.minimum(ea, eb).amax(-1).clamp(min=0.0)
        tx = torch.maximum(ea, eb).amin(-1)
        per = S / (t1 - t0)
        kf = torch.nan_to_num(torch.floor((te - t0) * per - 0.5) - 1.0)
        ke = torch.nan_to_num(torch.ceil((tx - t0) * per - 0.5) + 2.0)
        kf, ke = kf.clamp(0, S).long(), ke.clamp(0, S).long()
        kf = torch.minimum(kf, ke)
        # ... and its proof: step kf - 1 before the box, step ke past it
        below, above = ~(q >= lo[:, :, None]), ~(q <= hb[:, :, None])
        pos, neg = (d > 0)[:, :, None], (d < 0)[:, :, None]
        before = torch.where(pos, below, torch.where(
            neg, above, below | above)).any(-1)
        past = torch.where(pos, above, neg & below).any(-1)

        def at(a, k):
            return a.gather(2, k.clamp(0, S - 1)[..., None])[..., 0]

        kf = torch.where((kf == 0) | at(before, kf - 1), kf, 0)
        ke = torch.where((ke == S) | at(past, ke), ke, S)
        k = torch.arange(S)
        span = (k >= kf[..., None]) & (k < ke[..., None])
        got = (hit & span).any(-1) & live
        assert torch.equal(got, hit.any(-1) & live & ok[so]), "a hit lost"
        walked = torch.where(got, (hit & span).int().argmax(-1) + 1, ke)
        in_box = ~before & ~past & (k < first[..., None])
        meets = (t1 > t0) & ok[so]
        out["rays"] += int(meets.sum())
        out["miss_hull"] += int((meets & ~hit.any(-1)).sum())
        out["steps"] += int(first[meets].sum())
        out["steps_in_box"] += int((in_box & live[..., None]).sum())
        out["steps_range"] += int(((walked - kf).clamp(min=0))[live].sum())
        cov.append((got & ok[so]).sum(1, dtype=torch.int32))
    assert torch.equal(torch.cat(cov), counts[0]), "covered != plain"
    assert out["steps"] == counts[2], "steps != the plain version's count"
    return out


def k11b_tests(args):
    """Voxel-view tests a voxel of one K11b launch, ring and spread order."""
    from plant3dvision_tpu_torch.ops import carving
    packed, cams, origin, vs, shape, hw, tol = args
    V = cams.shape[1]
    s = int(0.618 * V + 0.5)
    while math.gcd(s, V) != 1:
        s += 1
    valid = torch.ones(V, dtype=torch.bool)
    out = {"voxels": 0, "ring": 0, "spread": 0}
    for c in cams:
        views = [(i & ~h) for i, h, _ in carving._view_tests(
            packed, c, valid, origin, vs, shape, hw)]
        out["voxels"] += int(np.prod(shape))
        for name, order in (("ring", range(V)),
                            ("spread", [k * s % V for k in range(V)])):
            kills = torch.zeros(shape, dtype=torch.int32)
            for v in order:
                out[name] += int((kills <= tol).sum())
                kills += views[v].int()
    return out


def main():
    import selfcal_ab
    import chip_smoke as cs
    from plant3dvision_tpu_torch.ops import carving, selfcal
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--candidates", type=int, default=8)
    a = ap.parse_args()
    torch.set_num_threads(8)
    with tempfile.TemporaryDirectory() as tmp:
        selfcal_ab.scene(Path(tmp) / "scene.npz")
        z = np.load(Path(tmp) / "scene.npz")
    hull = {x: list(map(float, z["hull"][i])) for i, x in enumerate("xyz")}
    k11b, k12 = cs.selfcal_launches(
        z["masks"], z["poses"], z["theta"], torch.from_numpy(z["theta"]),
        torch.from_numpy(z["jitter"]), hull, cs.FRONTEND_BBOX, device="cpu")
    B, V = a.candidates, z["masks"].shape[0]
    alive = {}
    for name, args in k11b.items():
        args = (args[0], args[1][:B].contiguous(), *args[2:])
        alive[name] = carving.carve_candidates_plain(*args)
        print(json.dumps({"k11b": name, **k11b_tests(args)}), flush=True)
    for name, (src, make, groups) in k12.items():
        cargs = make(alive[src])
        n = alive[src].shape[0] * V if name != "polish" else groups
        cargs = (*(x[:n] for x in cargs[:3]), *cargs[3:])
        counts = selfcal.ray_coverage_counts_plain(*cargs, count_work=True)
        print(json.dumps({"k12": name, "groups": n,
                          **k12_walks(cargs, counts)}), flush=True)


if __name__ == "__main__":
    main()
