"""Self-supervised segmentation bootstrapping from a single real scan (port
of plant3dvision_tpu/models/distill.py).

The geometric route's 3D reconstruction of the scan provides per-view
organ pseudo-labels (the tree-graph-classified point cloud reprojected
into every view), a compact CNN is trained on them on the card, and the ML
route then runs on the same rig with that checkpoint: no downloaded
weights, no manual annotation.

Pipeline:
  geom route (Masks -> Voxels -> PointCloud -> ... -> TreeGraph)
    -> label_points_from_tree      points classified stem/fruit by the
                                   nearest skeleton node's label
    -> render_pseudo_labels        per-view label maps: project labeled
                                   points, per-class vote counts, plant
                                   mask gating, ignore where ambiguous
    -> build_crops                 plant-centered training crops
    -> train_synth.train_on_crops  the device-resident training loop
                                   (ignore-aware loss, K20-K23)

Held-out views (every ``val_every``-th) are excluded from training and
scored against their own pseudo-labels for a generalization IoU (the
tiles' argmax assembled on the device, K23's counts). The labelling,
rendering and cropping are host numpy, as in the JAX package.

CLI:
    python -m plant3dvision_tpu_torch.models.distill --db <db> \
        --scan real_plant --config configs/geom_pipe_real_selfcal.toml \
        --out segnet_real.npz [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np
import torch

from ..runtime.log import configure_logger

logger = configure_logger(__name__)

REPO = Path(__file__).resolve().parents[2]

#: the bootstrap label set: a bolted arabidopsis scan resolves into stem
#: plus fruit-bearing side organs (silique + pedicel), which is exactly
#: what the organ-based angle route needs (reference arabidopsis.py:379-506)
LABELS_REAL = ["background", "stem", "fruit"]
IGNORE = 255


# ------------------------------------------------------------ labelling

def label_points_from_tree(points, tree):
    """Classify each 3D point by its nearest tree-graph node.

    Nodes whose label list contains 'fruit' vote fruit (2); stem and
    branching ('node') nodes vote stem (1). Returns uint8 (N,).
    """
    from scipy.spatial import cKDTree

    node_ids = list(tree.nodes)
    coords = np.asarray([tree.nodes[n]["position"] for n in node_ids],
                        dtype=np.float32)
    is_fruit = np.asarray(
        ["fruit" in tree.nodes[n]["labels"] for n in node_ids], bool)
    _, idx = cKDTree(coords).query(np.asarray(points, np.float32), k=1)
    return np.where(is_fruit[idx], np.uint8(2), np.uint8(1))


def render_pseudo_labels(points, point_labels, cameras, plant_masks,
                         dilate=2, ambiguous=0.5, min_votes=1):
    """Per-view pseudo-label maps from a labeled point cloud.

    points: (N, 3) float32 world; point_labels: (N,) uint8 in {1 stem,
    2 fruit}; cameras: (V, 16) packed [fx,fy,cx,cy,R9,t3] (ops.carving
    layout); plant_masks: (V, H, W) bool — the geometric route's Masks.

    Returns (V, H, W) uint8 in {0 background, 1 stem, 2 fruit, IGNORE}.
    A pixel is IGNORE when the evidence is unusable for training: plant
    mask on but no projected votes (unreconstructed structures such as
    leaves or pot rim), runner-up class within `ambiguous` of the winner
    (stem/fruit overlap in projection), or votes landing outside the
    plant mask (pose error fringe).
    """
    from scipy.ndimage import maximum_filter

    points = np.asarray(points, np.float32)
    V = len(cameras)
    H, W = plant_masks.shape[1:]
    n_cls = 2
    out = np.empty((V, H, W), np.uint8)
    for v in range(V):
        cam = np.asarray(cameras[v], np.float32)
        fx, fy, cx, cy = cam[0:4]
        R = cam[4:13].reshape(3, 3)
        t = cam[13:16]
        p = points @ R.T + t
        z = p[:, 2]
        valid = z > 1e-6
        px = np.round(p[:, 0] / np.maximum(z, 1e-6) * fx + cx).astype(np.int64)
        py = np.round(p[:, 1] / np.maximum(z, 1e-6) * fy + cy).astype(np.int64)
        valid &= (px >= 0) & (px < W) & (py >= 0) & (py < H)
        counts = np.zeros((n_cls, H, W), np.float32)
        for c in range(n_cls):
            sel = valid & (point_labels == c + 1)
            np.add.at(counts[c].reshape(-1), py[sel] * W + px[sel], 1.0)
        if dilate > 0:
            size = 2 * dilate + 1
            for c in range(n_cls):
                counts[c] = maximum_filter(counts[c], size=size)
        top = counts.max(axis=0)
        winner = counts.argmax(axis=0).astype(np.uint8) + 1
        second = counts.min(axis=0)  # n_cls == 2
        has_votes = top >= min_votes
        amb = has_votes & (second > ambiguous * top)
        mask = plant_masks[v].astype(bool)
        lab = np.zeros((H, W), np.uint8)
        lab[mask & has_votes] = winner[mask & has_votes]
        lab[mask & ~has_votes] = IGNORE
        lab[~mask & has_votes] = IGNORE
        lab[amb] = IGNORE
        out[v] = lab
    return out


# -------------------------------------------------------------- dataset

def build_crops(images, label_maps, crop=448, per_view=10, bg_per_view=2,
                seed=0):
    """Plant-centered training crops + a few pure-background crops.

    images: (V, H, W, 3) uint8; label_maps: (V, H, W) uint8 (IGNORE ok).
    Returns (rgb (N,c,c,3) uint8, lab (N,c,c) uint8).
    """
    rng = np.random.default_rng(seed)
    V, H, W = label_maps.shape
    rgbs, labs = [], []
    for v in range(V):
        lm = label_maps[v]
        ys, xs = np.nonzero((lm > 0) & (lm != IGNORE))
        for _ in range(per_view):
            if len(ys) == 0:
                break
            i = rng.integers(len(ys))
            yc = int(ys[i]) + int(rng.integers(-crop // 4, crop // 4 + 1))
            xc = int(xs[i]) + int(rng.integers(-crop // 4, crop // 4 + 1))
            y0 = np.clip(yc - crop // 2, 0, H - crop)
            x0 = np.clip(xc - crop // 2, 0, W - crop)
            rgbs.append(images[v][y0:y0 + crop, x0:x0 + crop])
            labs.append(lm[y0:y0 + crop, x0:x0 + crop])
        for _ in range(bg_per_view):
            y0 = int(rng.integers(0, H - crop + 1))
            x0 = int(rng.integers(0, W - crop + 1))
            rgbs.append(images[v][y0:y0 + crop, x0:x0 + crop])
            labs.append(lm[y0:y0 + crop, x0:x0 + crop])
    return np.stack(rgbs), np.stack(labs)


# ---------------------------------------------------------- orchestration

def pseudo_labels_for_scan(ctx, camera_metadata="colmap_camera",
                           mask_task="Masks", pcd_task="PointCloud",
                           tree_task="TreeGraph", dilate=2, ambiguous=0.5):
    """Run the geometric route on `ctx` (as configured) and return
    (image_files, images (V,H,W,3) u8, label_maps (V,H,W) u8, stats)."""
    from ..fsdb import io
    from ..ops.carving import camera_from_metadata
    from ..runtime import run_task
    from ..utils import locate_task_filesets

    report = run_task(ctx, tree_task, report=False)

    def _fs(name):
        fs = report.get(name, {}).get("fileset")
        if not fs:
            fs = locate_task_filesets(ctx.scan, [name])[name]
        return ctx.scan.get_fileset(fs)

    tree = io.read_graph(_fs(tree_task).get_files()[0])
    pcd = io.read_point_cloud(_fs(pcd_task).get_files()[0])
    plabels = label_points_from_tree(pcd.points, tree)

    mask_files = _fs(mask_task).get_files()
    images_fs = ctx.scan.get_fileset("images")
    cams, masks, imgs, files = [], [], [], []
    for mf in mask_files:
        md = mf.get_metadata()
        cam_md = md.get(camera_metadata)
        if cam_md is None:
            continue
        img_f = images_fs.get_file(mf.id)
        if img_f is None:
            continue
        cams.append(camera_from_metadata(cam_md))
        masks.append(io.read_image(mf) > 127)
        img = io.read_image(img_f)
        if img.ndim == 2:
            img = np.repeat(img[..., None], 3, axis=-1)
        imgs.append(img[..., :3])
        files.append(img_f)
    masks = np.stack(masks)
    imgs = np.stack(imgs)
    cams = np.stack(cams)
    label_maps = render_pseudo_labels(pcd.points, plabels, cams, masks,
                                      dilate=dilate, ambiguous=ambiguous)
    n_plant = int(((label_maps > 0) & (label_maps != IGNORE)).sum())
    stats = {
        "n_points": int(len(pcd.points)),
        "fruit_point_fraction": round(float((plabels == 2).mean()), 4),
        "views": int(len(files)),
        "labeled_plant_px_per_view": int(n_plant / max(len(files), 1)),
        "ignore_px_per_view": int((label_maps == IGNORE).sum()
                                  / max(len(files), 1)),
        "fruit_px_fraction": round(float(
            (label_maps == 2).sum() / max(n_plant, 1)), 4),
    }
    logger.info(f"pseudo-labels: {stats}")
    return files, imgs, label_maps, stats


def distill_scan(ctx, crop=448, per_view=10, steps=2000, batch_size=8,
                 arch="resunet", widths=(24, 48, 96, 192),
                 blocks_per_stage=2, lr=3e-3, seed=0, val_every=6,
                 camera_metadata="colmap_camera", dilate=2, ambiguous=0.5):
    """Full bootstrap: geom route -> pseudo-labels -> training on
    `ctx.device`.

    Returns (model, config, report) where report carries pseudo-label
    stats and held-out-view IoU (vs the held-out views' own
    pseudo-labels, IGNORE pixels excluded).
    """
    from .train_synth import train_on_crops

    files, imgs, label_maps, stats = pseudo_labels_for_scan(
        ctx, camera_metadata=camera_metadata, dilate=dilate,
        ambiguous=ambiguous)

    V = len(files)
    val_idx = np.arange(V)[::val_every] if val_every else np.array([], int)
    train_idx = np.setdiff1d(np.arange(V), val_idx)
    rgb, lab = build_crops(imgs[train_idx], label_maps[train_idx],
                           crop=crop, per_view=per_view, seed=seed)
    logger.info(f"training crops: {rgb.shape} from {len(train_idx)} views "
                f"({len(val_idx)} held out)")
    model, config, history = train_on_crops(
        rgb, lab, widths=widths, blocks_per_stage=blocks_per_stage,
        steps=steps, batch_size=batch_size, lr=lr, seed=seed, arch=arch,
        labels=LABELS_REAL, ignore_index=IGNORE, device=ctx.device)

    val = {}
    if len(val_idx):
        val = _heldout_iou(model, imgs[val_idx], label_maps[val_idx])
        logger.info(f"held-out view IoU: {val}")
    config["distill"] = {"scan": ctx.scan.id, "views": V,
                         "held_out_views": len(val_idx),
                         "pseudo_labels": stats, "heldout_iou": val}
    report = {"stats": stats, "heldout_iou": val, "history": history}
    return model, config, report


def _heldout_iou(model, imgs, label_maps, tile=448):
    """Per-class IoU on full held-out views, IGNORE pixels excluded: each
    view's tiled argmax (on the model's device) against its label map by
    K23's counts, summed over the views."""
    from ..ops.training import iou_counts

    dev = next(model.parameters()).device
    n = len(LABELS_REAL)
    counts = torch.zeros((3, n), dtype=torch.int64, device=dev)
    for img, lm in zip(imgs, label_maps):
        pred = _tiled_argmax(model, img, tile)
        lab = torch.from_numpy(np.ascontiguousarray(lm, np.uint8)).to(dev)
        counts += iou_counts(lab[None], n, preds=pred[None],
                             ignore_index=IGNORE)
    inter, union = counts[0].cpu().numpy(), counts[1].cpu().numpy()
    return {LABELS_REAL[c]: round(float(inter[c] / union[c]), 4)
            for c in range(n) if union[c] > 0}


@torch.no_grad()
def _tiled_argmax(model, img, tile):
    """(H, W) uint8 argmax of the model over `tile`-sized patches of one
    (H, W, 3) uint8 image (edge patches shifted inside the image; each
    output pixel from the patch that starts at its tile), on the model's
    device. The patch is divided by 255 in numpy, as the JAX package
    divides it on the host."""
    dev = next(model.parameters()).device
    H, W = img.shape[:2]
    pred = torch.zeros((H, W), dtype=torch.uint8, device=dev)
    for y0 in range(0, H, tile):
        for x0 in range(0, W, tile):
            y1, x1 = min(y0 + tile, H), min(x0 + tile, W)
            ys, xs = max(y1 - tile, 0), max(x1 - tile, 0)
            patch = img[ys:y1, xs:x1].astype(np.float32) / 255.0
            x = torch.from_numpy(patch).to(dev).permute(2, 0, 1)[None]
            logits = model(x.contiguous())
            p = logits[0].argmax(0).to(torch.uint8)
            pred[y0:y1, x0:x1] = p[y0 - ys:, x0 - xs:]
    return pred


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--db", default=None,
                    help="FSDB path; default: a temporary DB holding the "
                         "reference scan (needs P3D_REF_TESTDATA)")
    ap.add_argument("--scan", default="real_plant")
    ap.add_argument("--config", default=str(
        REPO / "configs" / "geom_pipe_real_selfcal.toml"))
    ap.add_argument("--out", default="segnet_real_distilled.npz",
                    help="checkpoint path (default: in the current "
                         "directory)")
    ap.add_argument("--report", default=None, help="JSON report path")
    ap.add_argument("--steps", type=int, default=2000)
    ap.add_argument("--crop", type=int, default=448)
    ap.add_argument("--per-view", type=int, default=10)
    ap.add_argument("--arch", default="resunet",
                    choices=["resunet", "tpusegnet"])
    ap.add_argument("--widths", type=int, nargs="+",
                    default=[24, 48, 96, 192])
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the "
                         "kernels' plain versions)")
    args = ap.parse_args(argv)

    from ..runtime import RunContext
    from ..runtime.config import load_toml
    from .checkpoint import flax_params, params_to_npz_bytes

    cfg = load_toml(args.config)

    def _run(db):
        ctx = RunContext(db, args.scan, cfg, device=args.device)
        model, config, report = distill_scan(
            ctx, crop=args.crop, per_view=args.per_view, steps=args.steps,
            batch_size=args.batch_size, arch=args.arch,
            widths=tuple(args.widths))
        out = Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_bytes(params_to_npz_bytes(flax_params(model), config))
        logger.info(f"checkpoint -> {out}")
        if args.report:
            Path(args.report).write_text(json.dumps(report, indent=1))
        return report

    from ..fsdb.db import FSDB
    if args.db:
        db = FSDB(args.db)
        db.connect()
        try:
            return _run(db)
        finally:
            db.disconnect()
    from ..fsdb.testing import TemporaryDB
    from .train_synth import _ref_testdata
    ref = _ref_testdata()
    if ref is None or not (ref / args.scan / "files.json").exists():
        raise SystemExit("give --db, or set P3D_REF_TESTDATA to the "
                         f"reference test data holding '{args.scan}'")
    import shutil
    with TemporaryDB() as db:
        shutil.copytree(ref / args.scan, db.path() / args.scan)
        db.refresh()
        return _run(db)


if __name__ == "__main__":
    main()
