"""Run every multi-rank program of the port once over N ranks on small
shapes (port of __graft_entry__.py's `dryrun_multichip(n)`): the train
step on the JAX package's dp x tp layout (the convolutions split over
tp), `train_on_crops(use_mesh=True)` on it, the view-sharded,
grid-sharded, hierarchical and 2-D carves, the bench workload's carve
(60 views of 1440x1080 into 301x301x561 at 0.5 mm) bit-equal to the
one-device carve, dp inference, the x-slab averaging volume, and a
miniature pipeline through the task runtime with the sharded engines and
dp segmentation, equal to the one-device run.

    python -m plant3dvision_tpu_torch.tools.dryrun_multichip N \
        [--device cpu|cuda] [--backend gloo|nccl] [--skip-workload]

On the card, ranks that share one card need `--backend gloo`. Prints one
"[dryrun] ... ok" line a stage; raises on the first failure.
"""

from __future__ import annotations

import argparse
import copy
import io
import json
import time

import numpy as np
import torch


def _ring_views(V, H, W, seed=0):
    from ..camera import pose_to_extrinsics
    from ..ops.carving import pack_camera

    rng = np.random.default_rng(seed)
    masks = (rng.random((V, H, W)) > 0.3).astype(np.uint8) * 255
    cams = np.zeros((V, 16), np.float32)
    for v in range(V):
        a = 2 * np.pi * v / V
        R, t = pose_to_extrinsics([40 * np.cos(a), 40 * np.sin(a), 0.0],
                                  (0, 0, 0))
        cams[v] = pack_camera([80.0, 80.0, W / 2, H / 2], R, t)
    return masks, cams, np.ones(V, bool)


#: the north-star plant (chip_smoke.py's scans)
NORTHSTAR_PLANT = dict(n_fruits=15, divergence_deg=137.5, internode=6.0,
                       stem_radius=2.0, fruit_radius=1.5, fruit_length=35.0,
                       first_node=30.0)


def bench_workload():
    """bench.py's workload on the north-star plant (chip_smoke.py phases 4
    and 25): 60 views of 1440x1080 bit-packed, their cameras, the origin,
    voxel size, the 301x301x561 grid and (H, W)."""
    from ..ops.carving import pack_camera, pack_masks
    from ..synth import SyntheticPlant, render_mask, turntable_cameras

    V, H, W = 60, 1080, 1440
    plant = SyntheticPlant(**NORTHSTAR_PLANT)
    rows = np.zeros((V, (H * W + 7) // 8), np.uint8)
    cams = np.zeros((V, 16), np.float32)
    for v, (K, R, t) in enumerate(turntable_cameras(
            V, dist=450.0, z=120.0, target=(0, 0, 70.0), f=1400.0,
            width=W, height=H)):
        rows[v] = pack_masks(render_mask(plant, K, R, t, W, H, step=0.5))
        cams[v] = pack_camera([K[0, 0], K[1, 1], K[0, 2], K[1, 2]], R, t)
    return (rows, cams, np.array([-75.0, -75.0, -20.0], np.float32), 0.5,
            (301, 301, 561), (H, W))


def _mini_pipeline(n, dev, mesh):
    """Stage 9: images -> angles with FusedCarving(engine="sharded"),
    Segmentation2D(data_parallel=True) and Voxels(engine="sharded",
    averaging) through the runtime, against the same run on one rank."""
    from ..fsdb.testing import TemporaryDB
    from ..models.checkpoint import flax_params, model_from_config, save_model
    from ..runtime import RunContext, run_task
    from ..synth import SyntheticPlant, generate_ml_scan

    labels = ["background", "stem", "pedicel", "fruit"]
    plant = SyntheticPlant(n_fruits=8, divergence_deg=137.5, internode=9.0,
                           stem_radius=2.5, fruit_radius=2.0,
                           fruit_length=22.0, first_node=20.0)
    cfg = {
        "FusedCarving": {"upstream_task": "ImagesFilesetExists",
                         "camera_metadata": "camera", "voxel_size": 1.5,
                         "type": "linear", "parameters": [-1.0, -1.0, -1.0],
                         "threshold": -2.5, "engine": "fused"},
        "PointCloud": {"upstream_task": "FusedCarving",
                       "level_set_value": 0.0},
        "CurveSkeleton": {"upstream_task": "PointCloud", "bin_size": 2.0,
                          "k": 10, "stem_axis_inverted": True},
        "TreeGraph": {"upstream_task": "CurveSkeleton", "z_axis": 2,
                      "stem_axis_inverted": True},
        "AnglesAndInternodes": {"upstream_task": "TreeGraph",
                                "node_sampling_dist": 10,
                                "min_fruit_size": 4},
        "Segmentation2D": {"upstream_task": "ImagesFilesetExists",
                           "Sx": 128, "Sy": 128, "binarize": True,
                           "threshold": 0.5, "batch_size": 8,
                           "data_parallel": False},
        "Voxels": {"upstream_mask": "Segmentation2D",
                   "upstream_colmap": "DummyTask",
                   "camera_metadata": "camera", "voxel_size": 1.5,
                   "type": "averaging", "log": True, "engine": "auto"},
        "Clean": {"no_confirm": True},
    }

    def outputs(ctx):
        fs = ctx.scan.get_fileset(ctx.get_task("FusedCarving").task_id())
        carved = np.load(io.BytesIO(fs.get_files()[0].read_raw()))["volume"]
        fs = ctx.scan.get_fileset(
            ctx.get_task("AnglesAndInternodes").task_id())
        angles = json.loads(fs.get_file("AnglesAndInternodes").read_raw())[
            "angles"]
        fs = ctx.scan.get_fileset(ctx.get_task("Voxels").task_id())
        z = np.load(io.BytesIO(fs.get_files()[0].read_raw()))
        vols = {k: z[k] for k in z.files}
        fs = ctx.scan.get_fileset(ctx.get_task("Segmentation2D").task_id())
        return angles, vols, {f.id: f.read_raw() for f in fs.get_files()}, \
            carved

    torch.manual_seed(3)
    model = model_from_config({"arch": "resunet", "widths": [8, 16],
                               "blocks_per_stage": 1, "label_names": labels})
    with TemporaryDB() as db:
        scan = generate_ml_scan(db, "mini", n_views=18, width=128,
                                height=128, f=180.0, plant=plant)
        mfs = scan.get_fileset("models", create=True)
        save_model(mfs.create_file("tiny"), flax_params(model),
                   {"label_names": labels, "widths": [8, 16],
                    "blocks_per_stage": 1})
        ctx = RunContext(db, "mini", cfg, device=dev, ranks=1)
        run_task(ctx, "AnglesAndInternodes", report=False)
        run_task(ctx, "Voxels", report=False)
        a = outputs(ctx)
        run_task(ctx, "Clean", report=False)
        cfg_b = copy.deepcopy(cfg)
        cfg_b["FusedCarving"]["engine"] = "sharded"
        cfg_b["Voxels"]["engine"] = "sharded"
        cfg_b["Segmentation2D"]["data_parallel"] = True
        ctx = RunContext(db, "mini", cfg_b, device=dev, mesh=mesh)
        run_task(ctx, "AnglesAndInternodes", report=False)
        run_task(ctx, "Voxels", report=False)
        b = outputs(ctx)
    assert len(a[0]) >= 3, f"the mini pipeline gave {len(a[0])} angles"
    assert np.array_equal(a[3], b[3]), "the sharded carve differs"
    assert a[0] == b[0], "the sharded pipeline's angles differ"
    assert a[1].keys() == b[1].keys() and all(
        np.array_equal(a[1][k], b[1][k]) for k in a[1]), \
        "sharded averaging volumes differ"
    assert a[2] == b[2], "dp segmentation wrote other masks"
    return len(a[0]), len(a[1])


def dryrun_multichip(n: int, device="cuda", backend=None,
                     workload=True) -> None:
    from ..models.checkpoint import model_from_config
    from ..models.train_synth import _make_model, train_on_crops
    from ..models.unet import segmentation_inference
    from ..ops.carving import average, carve, pack_masks
    from ..parallel import carve_sharded, make_mesh, make_train_step
    from ..parallel.carving import (average_grid_sharded, carve_2d_sharded,
                                    carve_grid_sharded)
    from ..parallel.carving_mp import carve_sharded_hierarchical
    from ..parallel.mesh import best_dp_tp
    from ..parallel.train import shard_params

    dev = torch.device(device)
    mesh = make_mesh({"dp": n}, device=dev, backend=backend)
    try:
        # 1. the dp x tp train step
        axes = best_dp_tp(n)
        tmesh = mesh.view(axes)
        model = _make_model("resunet", 0, (32, 64), 1, n_classes=6)
        params = shard_params(model, tmesh)
        step, shard_batch = make_train_step(model, {"lr": 1e-3}, tmesh)
        B = 2 * axes["dp"]
        rng = np.random.default_rng(0)
        x, y = shard_batch(rng.random((B, 64, 64, 3)).astype(np.float32),
                           rng.integers(0, 6, (B, 64, 64)))
        held = params.held()
        params, opt_state, loss = step(params, None, x, y)
        assert np.isfinite(loss)
        macs = [s["conv_macs"]["forward"] for s in opt_state.rank_stats()]
        opt_state.close()
        whole = sum(p.numel() for p in model.parameters())
        print(f"[dryrun] train step ok on mesh {tmesh.shape}; "
              f"loss={loss:.4f}; parameters held a rank {held} of {whole} "
              f"({len(params.split())} kernels split); conv MACs a rank "
              f"forward {macs}")

        # 1b. train_on_crops through the same policy
        crops = rng.integers(0, 255, (8, 32, 32, 3), dtype=np.uint8)
        labs = rng.integers(0, 2, (8, 32, 32)).astype(np.uint8)
        _, _, hist = train_on_crops(
            crops, labs, widths=(4, 8), blocks_per_stage=1, steps=25,
            batch_size=2 * axes["dp"], labels=["background", "plant"],
            val_fraction=0.25, device=dev, use_mesh=True, mesh=tmesh)
        assert np.isfinite(hist[-1]["loss"])
        print(f"[dryrun] train_on_crops sharded chunk ok on {tmesh.shape}; "
              f"loss={hist[-1]['loss']:.4f}")

        # 2-4. view-sharded, grid-sharded, hierarchical carves
        masks, cams, valid = _ring_views(2 * n, 64, 64)
        ref = carve(torch.from_numpy(pack_masks(masks)).to(dev),
                    torch.from_numpy(cams).to(dev),
                    torch.from_numpy(valid).to(dev), np.zeros(3), 1.0,
                    (16, 16, 16), (64, 64))
        vol = carve_sharded(masks, cams, valid, np.zeros(3), 1.0,
                            (16, 16, 16), mesh)
        assert torch.equal(vol, ref)
        print(f"[dryrun] view-sharded carve ok over {n} ranks")
        org = np.array([-8.0, -8.0, -8.0], np.float32)
        gshape = (16 * n, 16, 16)
        gref = carve(torch.from_numpy(pack_masks(masks)).to(dev),
                     torch.from_numpy(cams).to(dev),
                     torch.from_numpy(valid).to(dev), org, 1.0, gshape,
                     (64, 64))
        assert torch.equal(carve_grid_sharded(masks, cams, valid, org, 1.0,
                                              gshape, mesh), gref)
        print(f"[dryrun] grid-sharded carve ok over {n} ranks")
        h = carve_sharded_hierarchical(masks, cams, valid, org, 1.0,
                                       (16, 16, 16), mesh, cap=4096)
        assert h.shape == (16, 16, 16)
        print(f"[dryrun] view-sharded hierarchical carve ok over {n} ranks")

        # 5. bench.py's workload, bit-equal to the one-device carve
        if workload:
            rows, wcams, worg, wvs, wshape, hw = bench_workload()
            t0 = time.perf_counter()
            one = carve(torch.from_numpy(rows).to(dev),
                        torch.from_numpy(wcams).to(dev),
                        torch.ones(len(rows), dtype=torch.bool, device=dev),
                        worg, wvs, wshape, hw)
            t_one = time.perf_counter() - t0
            t0 = time.perf_counter()
            sh = carve_sharded_hierarchical(
                None, wcams, np.ones(len(rows), bool), worg, wvs, wshape,
                mesh, packed=rows, hw=hw)
            t_sh = time.perf_counter() - t0
            assert torch.equal(sh, one), "the sharded workload carve differs"
            print(f"[dryrun] workload carve ok: {len(rows)} views, grid "
                  f"{wshape}, bit-equal; {t_sh:.2f} s over {n} ranks, "
                  f"{t_one:.2f} s on one")

        # 6. dp inference
        seg = model_from_config({"arch": "resunet", "widths": [16, 32],
                                 "blocks_per_stage": 1,
                                 "label_names": [str(i) for i in range(6)]})
        imgs = (rng.random((2 * n, 64, 64, 3)) * 255).astype(np.uint8)
        a = segmentation_inference(seg, imgs, batch_size=n,
                                   data_parallel=False, device=dev)
        b = segmentation_inference(seg, imgs, batch_size=n,
                                   data_parallel=True, device=dev, mesh=mesh)
        assert torch.equal(a, b), "dp inference differs"
        print(f"[dryrun] dp segmentation inference ok: batch {n} over "
              f"{n} ranks")

        # 7. x-slab averaging
        soft = torch.from_numpy(masks.astype(np.float32) / 255.0)
        avg = average(soft.to(dev), torch.from_numpy(cams).to(dev),
                      torch.from_numpy(valid).to(dev), org, 1.0, gshape)
        assert torch.equal(average_grid_sharded(soft, cams, valid, org, 1.0,
                                                gshape, mesh), avg)
        print(f"[dryrun] grid-sharded averaging volume ok over {n} ranks "
              "(bit-equal to one device)")

        # 8. 2-D carve
        if n % 2 == 0:
            m2 = mesh.view({"vp": 2, "gp": n // 2})
            s2 = (16 * (n // 2), 16, 16)
            r2 = carve(torch.from_numpy(pack_masks(masks)).to(dev),
                       torch.from_numpy(cams).to(dev),
                       torch.from_numpy(valid).to(dev), org, 1.0, s2,
                       (64, 64))
            assert torch.equal(carve_2d_sharded(masks, cams, valid, org, 1.0,
                                                s2, m2), r2)
            print(f"[dryrun] 2D-mesh carve ok: 2x{n // 2}, bit-exact")

        # 9. the mini pipeline through the runtime
        n_angles, n_labels = _mini_pipeline(n, dev, mesh)
        print(f"[dryrun] FULL mini-pipeline ok on {n} ranks: the sharded "
              f"carve and {n_angles} angles equal one rank's; dp seg "
              f"masks identical; sharded averaging equal ({n_labels} "
              "labels)")
    finally:
        mesh.close()


def main(argv=None):
    ap = argparse.ArgumentParser(prog="dryrun_multichip")
    ap.add_argument("n", type=int, nargs="?", default=8)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--backend", default=None, choices=["gloo", "nccl"])
    ap.add_argument("--skip-workload", action="store_true",
                    help="leave out stage 5 (bench.py's workload)")
    args = ap.parse_args(argv)
    dryrun_multichip(args.n, args.device, args.backend,
                     workload=not args.skip_workload)
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(main())
