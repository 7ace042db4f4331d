"""Train the organ-segmentation ResUNet (or TPUSegNet) on photo-domain
synthetic renders (port of plant3dvision_tpu/models/train_synth.py).

The crops come from synth_photo's splat renderer (procedural plants and,
where the reference virtual_plant data is present, renders of its
ground-truth OBJ). On the card:
- the crop set is uploaded once and stays on the device (uint8 images and
  labels);
- each step draws its batch (crop indices, one flip, colour gains) from a
  `torch.Generator` on the device seeded by the step's number
  (`_draw_batch`), gathers, flips and scales it in one kernel (K20), runs
  the model (bf16 convolutions, float32 parameters), the weighted
  cross-entropy and its backward (K21) and the clipped AdamW step (K22)
  over one parameter arena; the backward is deterministic (cuDNN's
  deterministic algorithms, the resize's backward as matrix products, no
  float atomics in the kernels), so a run resumed from a saved state equals
  the uninterrupted run bit for bit;
- steps are grouped in chunks of STEPS_PER_CALL for the history and the
  checkpoints, as the JAX package's scanned chunks are; the chunk's mean
  loss is read back only where it is logged;
- the held-out crops' IoU goes through K23's counts.

The random stream is the port's own: the JAX package draws with threefry
keys, which the tests replay into `_draw_batch`.

CLI:
    python -m plant3dvision_tpu_torch.models.train_synth \
        --out unet_seg.npz --steps 3000 [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import time
from pathlib import Path

import numpy as np
import torch

from ..ops.training import (INV255, gather_batch, iou_counts,
                            iou_from_counts, weighted_cross_entropy)
from ..runtime.log import configure_logger

logger = configure_logger(__name__)

LABELS = ["background", "flower", "fruit", "leaf", "pedicel", "stem"]

STEPS_PER_CALL = 25


def _ref_testdata():
    """The reference test data directory (P3D_REF_TESTDATA), or None."""
    d = os.environ.get("P3D_REF_TESTDATA")
    return Path(d) if d else None


def _fixture_obj_path():
    """The virtual_plant fixture's ground-truth OBJ (if available)."""
    ref = _ref_testdata()
    vp = ref / "virtual_plant" if ref is not None else None
    if vp is None or not vp.exists():
        return None
    for d in vp.iterdir():
        if d.is_dir() and d.name.startswith("VirtualPlant"):
            obj = d / "VirtualPlant.obj"
            if obj.exists():
                return obj
    return None


# ------------------------------------------------------------- dataset

def _plant_crops(samples, n_views, crop, crops_per_view, rng, views_seed,
                 full_res=896):
    """Render a labeled sample set from `n_views` random ring cameras and
    cut plant-centered crops: (list of rgb uint8 (c,c,3), list of labels
    (c,c))."""
    from ..synth_photo import fixture_like_cameras, render_photo

    pts = np.concatenate([p for p, _ in samples.values()])
    lo, hi = pts.min(0), pts.max(0)
    target = (float((lo[0] + hi[0]) / 2), float((lo[1] + hi[1]) / 2),
              float((lo[2] + hi[2]) / 2))
    height = hi[2] - lo[2]
    vrng = np.random.default_rng(views_seed)
    cams = fixture_like_cameras(
        n_views, radius=vrng.uniform(0.55, 0.75) * max(height, 60.0),
        z=target[2] + vrng.uniform(0.0, 0.25) * height, target=target,
        rng=vrng, radius_jitter=0.04, z_jitter=2.0,
        phase=vrng.random() * 2 * np.pi)
    rgbs, labs = [], []
    for K, R, t in cams:
        rgb, _, lab = render_photo(samples, K, R, t, full_res, full_res,
                                   rng=rng, color_jitter=0.08,
                                   blur=bool(rng.random() < 0.5))
        ys, xs = np.nonzero(lab > 0)
        if len(ys) == 0:
            continue
        for _ in range(crops_per_view):
            i = rng.integers(len(ys))
            cy = int(np.clip(ys[i] - crop // 2 + rng.integers(-40, 40),
                             0, full_res - crop))
            cx = int(np.clip(xs[i] - crop // 2 + rng.integers(-40, 40),
                             0, full_res - crop))
            rgbs.append(rgb[cy:cy + crop, cx:cx + crop])
            labs.append(lab[cy:cy + crop, cx:cx + crop])
    return rgbs, labs


def build_training_set(n_procedural=12, views_per_plant=18, crop=448,
                       crops_per_view=2, density=150.0, seed=0,
                       include_fixture_obj=True):
    """Returns (rgb (N,c,c,3) uint8, lab (N,c,c) int8, meta dict)."""
    from ..synth_photo import ProceduralArabidopsis, obj_labeled_samples

    rng = np.random.default_rng(seed)
    rgbs, labs = [], []
    sources = []
    t0 = time.time()
    obj_path = _fixture_obj_path() if include_fixture_obj else None
    if obj_path is not None:
        for k in range(3):
            samples = obj_labeled_samples(obj_path, density=density,
                                          seed=seed + k)
            r, l = _plant_crops(samples, views_per_plant, crop,
                                crops_per_view, rng, views_seed=1000 + k)
            rgbs += r
            labs += l
        sources.append({"kind": "fixture_obj", "renders": 3 * views_per_plant})
    for p in range(n_procedural):
        plant = ProceduralArabidopsis(
            n_fruits=int(rng.integers(12, 42)),
            jitter_deg=rng.uniform(5, 20),
            internode=rng.uniform(1.8, 4.5),
            first_node=rng.uniform(8, 25),
            stem_radius=rng.uniform(0.15, 0.35),
            fruit_radius=rng.uniform(0.22, 0.42),
            n_leaves=int(rng.integers(4, 12)),
            stem_wander=rng.uniform(0.1, 0.5),
            seed=seed * 1000 + p)
        samples = plant.labeled_samples(density=density)
        r, l = _plant_crops(samples, views_per_plant, crop, crops_per_view,
                            rng, views_seed=2000 + p)
        rgbs += r
        labs += l
    sources.append({"kind": "procedural", "plants": n_procedural,
                    "renders": n_procedural * views_per_plant})
    rgb = np.stack(rgbs)
    lab = np.stack(labs).astype(np.int8)
    meta = {"sources": sources, "crop": crop, "n_crops": len(rgb),
            "labels": LABELS, "build_seconds": round(time.time() - t0, 1)}
    logger.info(f"training set: {rgb.shape} ({rgb.nbytes / 1e6:.0f} MB), "
                f"{meta['build_seconds']} s to build")
    return rgb, lab, meta


# ------------------------------------------------------------- training

def init_like_flax(model, generator):
    """Initialise `model` as flax initialises the JAX models, from an
    explicit CPU `torch.Generator`: convolution kernels from
    variance_scaling(1, "fan_in", "truncated_normal") (a normal truncated
    to [-2, 2], times sqrt(1 / fan_in) / 0.8796...), biases zero, norm
    scales one. Parameters are drawn in the module's order. Returns the
    model."""
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("bias"):
                p.zero_()
            elif p.ndim == 4:
                fan_in = p.shape[1] * p.shape[2] * p.shape[3]
                std = np.sqrt(1.0 / fan_in) / 0.87962566103423978
                w = torch.empty(p.shape, dtype=torch.float32)
                torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0,
                                            generator=generator)
                p.copy_(w * float(np.float32(std)))
            else:
                p.fill_(1.0)
    return model


def _make_model(arch, seed, widths, blocks_per_stage, n_classes=None,
                dtype=torch.bfloat16):
    """The architecture (float32 parameters, convolutions in `dtype`),
    initialised from `seed` (init_like_flax); on the CPU."""
    from .checkpoint import model_from_config
    n_classes = n_classes or len(LABELS)
    config = {"arch": arch, "widths": list(widths),
              "blocks_per_stage": blocks_per_stage,
              "label_names": [str(i) for i in range(n_classes)]}
    model = model_from_config(config)
    model.dtype = dtype
    return init_like_flax(model, torch.Generator().manual_seed(int(seed)))


def _step_seed(seed, step):
    """Seed of step `step`'s draw: a run resumed at any step replays it."""
    return (int(seed) + 1) * 1_000_003 + int(step)


def _draw_batch(gen, n, batch_size):
    """One step's draw on `gen`'s device: crop indices (B,) int64 in [0,
    n), one flip for the batch (1,) uint8 (probability 0.5) and colour
    gains 1 + 0.15 * normal, (B, 3) float32."""
    dev = gen.device
    idx = torch.randint(0, n, (batch_size,), generator=gen, device=dev)
    flip = (torch.rand(1, generator=gen, device=dev) < 0.5).to(torch.uint8)
    gains = 1.0 + 0.15 * torch.randn((batch_size, 3), generator=gen,
                                     device=dev)
    return idx, flip, gains


def class_weights(lab, n_cls, ignore_index=None):
    """train_on_crops' class weights: 1 / sqrt(max(freq, 1e-5 total)),
    normalised to sum to n_cls (float64, as the JAX package computes
    them before the float32 cast)."""
    flat = np.asarray(lab).ravel().astype(np.int64)
    if ignore_index is not None:
        flat = flat[flat != ignore_index]
    freq = np.bincount(flat, minlength=n_cls).astype(float)[:n_cls]
    w = 1.0 / np.sqrt(np.maximum(freq, freq.sum() * 1e-5))
    return freq, w / w.sum() * n_cls


def deterministic_backward():
    """cuDNN flags for a reproducible training step: deterministic
    algorithms, no autotuning, and float32 convolutions in float32 (no
    TF32; the bfloat16 convolutions are unaffected) (a context manager)."""
    cud = torch.backends.cudnn
    return cud.flags(enabled=cud.enabled, benchmark=False,
                     deterministic=True, allow_tf32=False)


@torch.no_grad()
def _val_counts(model, vrgb, vlab, n_cls, ignore_index, batch=8):
    """K23 counts of the model's argmax on the held-out crops (u8 on the
    device), summed over batches of `batch` crops."""
    total = None
    for i in range(0, len(vrgb), batch):
        x = (vrgb[i:i + batch].to(torch.float32) * INV255).permute(0, 3, 1, 2)
        logits = model(x.contiguous())
        c = iou_counts(vlab[i:i + batch], n_cls, logits=logits.contiguous(),
                       ignore_index=ignore_index)
        total = c if total is None else total + c
    return total


def train_on_crops(rgb, lab, widths=(24, 48, 96, 192), blocks_per_stage=2,
                   steps=3000, batch_size=8, lr=3e-3, seed=0,
                   val_fraction=0.05, arch="resunet", labels=None,
                   ignore_index=None, checkpoint_every_chunks=0,
                   on_checkpoint=None, resume_state=None, device="cuda",
                   dtype=torch.bfloat16, use_mesh="auto", mesh=None,
                   on_chunk=None):
    """Device-resident training loop; returns (model, config, history).

    `labels` defaults to the synthetic-scan label set; `ignore_index`
    (e.g. 255 for distillation pseudo-labels, models/distill.py) drops
    those pixels from the loss and the validation IoU. `dtype` is the
    convolutions' (float32 parameters either way).

    Chunk-level checkpoint/resume: every `checkpoint_every_chunks` chunks,
    `on_checkpoint(blob, chunk)` receives the serialized training state
    (models/checkpoint.py; the JAX package's layout); pass the blob back as
    `resume_state` to continue bit-identically (the draws are seeded by
    the step's number). A state that the JAX package wrote resumes too,
    with the port's stream from its next step.

    `use_mesh` ("auto" / True / False): with more than one rank (the
    ranks of `mesh`, else one a card on the card and one on the CPU;
    "auto" asks for exactly that) the trainer runs the dp x tp policy of
    parallel/train.py over the JAX package's layout, `best_dp_tp(ranks)`
    (`mesh`'s own where its axes are "dp" and "tp"): the crop set, the
    parameters (the convolutions split over tp) and the optimizer state
    resident on the ranks, each rank drawing the step's batch as one
    device draws it and taking its dp part, the batch size rounded up to
    a multiple of dp. A resumed run at the same layout equals the
    uninterrupted one bit for bit; the state is the one-device layout, so
    a state resumes at any layout.

    `on_chunk(chunk, losses)`, when given, receives each chunk's per-step
    losses ((STEPS_PER_CALL,) float32, on the CPU).
    """
    from ..runtime.config import resolve_device
    from .checkpoint import (flax_params, state_dict_from_flax,
                             training_state_from_npz_bytes,
                             training_state_to_npz_bytes)
    from ..parallel.mesh import best_dp_tp, default_ranks, make_mesh
    from .optim import AdamW, cosine_decay_schedule

    dev = resolve_device(device)
    ranks = mesh.size if mesh is not None else default_ranks(dev)
    if use_mesh == "auto":
        use_mesh = ranks > 1
    sharded = bool(use_mesh) and ranks > 1
    own_mesh = None
    if sharded:
        if mesh is None:
            mesh = own_mesh = make_mesh(best_dp_tp(ranks), device=dev)
        elif not set(mesh.axis_names) <= {"dp", "tp"}:
            mesh = mesh.view(best_dp_tp(ranks))
        dp = mesh.shape.get("dp", 1)
        if batch_size % dp:
            batch_size = -(-batch_size // dp) * dp
            logger.info(f"batch_size rounded to {batch_size} (multiple of "
                        f"dp={dp})")
        logger.info(f"sharded trainer: mesh {mesh.shape}")
    labels = list(labels) if labels is not None else list(LABELS)
    n, c = rgb.shape[:2]
    n_val = max(int(n * val_fraction), 2)
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n)
    val_idx, train_idx = perm[:n_val], perm[n_val:]

    n_cls = len(labels)
    model = _make_model(arch, seed, widths, blocks_per_stage,
                        n_classes=n_cls, dtype=dtype)
    n_params = sum(p.numel() for p in model.parameters())
    logger.info(f"model: widths={widths} blocks={blocks_per_stage} "
                f"params={n_params / 1e6:.2f} M")
    freq, w = class_weights(lab, n_cls, ignore_index)
    logger.info(f"class freq={freq.tolist()} weights={np.round(w, 3).tolist()}")
    w = torch.tensor(w, dtype=torch.float32, device=dev)
    opt_kw = dict(lr=cosine_decay_schedule(lr, steps, alpha=0.02), clip=1.0,
                  weight_decay=1e-4)

    # the crop set, uploaded once (to every rank on a mesh)
    crops = [torch.from_numpy(np.ascontiguousarray(a)) for a in (
        rgb[train_idx], lab[train_idx].astype(np.uint8), rgb[val_idx],
        lab[val_idx].astype(np.uint8))]
    n_train = len(train_idx)
    trainer = None
    if sharded:
        from ..parallel.train import MeshTrainer
        trainer = MeshTrainer(mesh, model, opt_kw, weights=w.cpu(),
                              ignore_index=ignore_index)
        trainer.load_data(*crops)
        model.to(dev)
    else:
        model.to(dev)
        opt = AdamW(model, **opt_kw)
        d_rgb, d_lab, d_vrgb, d_vlab = (t.to(dev) for t in crops)

    history = []
    start_chunk = 0
    if resume_state is not None:
        r_params, r_leaves, meta = training_state_from_npz_bytes(
            resume_state)
        if trainer is not None:
            trainer.load_state(r_params, r_leaves)
        else:
            with torch.no_grad():
                for k, v in state_dict_from_flax(r_params).items():
                    model.get_parameter(k).copy_(v.to(dev))
            opt.load_state_leaves(r_leaves)
        start_chunk = int(meta["chunk"]) + 1
        history = list(meta.get("history", []))
        logger.info(f"resumed training at chunk {start_chunk} "
                    f"(step {start_chunk * STEPS_PER_CALL})")
    gen = torch.Generator(device=dev)
    t0 = time.time()
    n_chunks = steps // STEPS_PER_CALL

    def local_chunk(chunk):
        losses = []
        for s in range(STEPS_PER_CALL):
            gen.manual_seed(_step_seed(seed, chunk * STEPS_PER_CALL + s))
            idx, flip, gains = _draw_batch(gen, n_train, batch_size)
            x, y = gather_batch(d_rgb, d_lab, idx, flip,
                                gains.to(torch.float32).contiguous())
            opt.zero_grad()
            loss = weighted_cross_entropy(model(x), y, w, ignore_index)
            loss.backward()
            opt.step()
            losses.append(loss.detach())
        return torch.stack(losses)

    with deterministic_backward():
        for chunk in range(start_chunk, n_chunks):
            if trainer is not None:
                losses = trainer.run_chunk(chunk, STEPS_PER_CALL, seed,
                                           batch_size, _draw_batch)
            else:
                losses = local_chunk(chunk)
            if on_chunk is not None:
                on_chunk(chunk, losses.cpu())
            if chunk % 10 == 0 or chunk == n_chunks - 1:
                loss = float(losses.mean())
                history.append({"step": (chunk + 1) * STEPS_PER_CALL,
                                "loss": loss,
                                "seconds": round(time.time() - t0, 1)})
                logger.info(f"step {(chunk + 1) * STEPS_PER_CALL}: "
                            f"loss={loss:.4f} ({time.time() - t0:.0f} s)")
            if (checkpoint_every_chunks and on_checkpoint is not None
                    and (chunk + 1) % checkpoint_every_chunks == 0
                    and chunk + 1 < n_chunks):
                meta = {"chunk": chunk,
                        # the JAX package resumes from a threefry key: a
                        # valid one, not the port's stream
                        "prng_key": [0, (chunk + 1) * STEPS_PER_CALL],
                        "history": history}
                state = (trainer.state() if trainer is not None
                         else (flax_params(model), opt.state_leaves()))
                on_checkpoint(training_state_to_npz_bytes(*state, meta),
                              chunk)
    if trainer is not None:
        iou = iou_from_counts(trainer.val_counts(n_cls, ignore_index))
        trainer.params_into(model)
        trainer.close()
        if own_mesh is not None:
            own_mesh.close()
    else:
        iou = iou_from_counts(_val_counts(model, d_vrgb, d_vlab, n_cls,
                                          ignore_index))
    val = {labels[i]: round(float(iou[i]), 4) for i in range(n_cls)
           if iou[i] >= 0}
    logger.info(f"held-out crop IoU: {val}")

    config = {"label_names": labels, "widths": list(widths),
              "arch": arch,
              "blocks_per_stage": blocks_per_stage,
              "train": {"steps": steps, "batch_size": batch_size, "lr": lr,
                        "n_crops": int(n), "crop": int(c),
                        "params_m": round(n_params / 1e6, 2),
                        "seconds": round(time.time() - t0, 1)},
              "val_iou": val}
    return model, config, history


def evaluate_on_fixture(model, batch_size=2):
    """Per-class IoU of the CNN on the 18 shipped fixture RENDERS (never
    seen in training) vs their GT channels; None without the reference
    test data (P3D_REF_TESTDATA)."""
    import glob

    import imageio.v2 as iio

    from .unet import segmentation_inference

    ref = _ref_testdata()
    if ref is None:
        return None
    img_dir = ref / "virtual_plant/images"
    rgb_files = sorted(glob.glob(str(img_dir / "*_rgb.png")))
    if not rgb_files:
        return None
    imgs = np.stack([iio.imread(f)[..., :3] for f in rgb_files])
    probs = segmentation_inference(model, imgs, batch_size=batch_size)
    pred = probs.argmax(1).cpu().numpy()
    out = {}
    for li, label in enumerate(LABELS):
        if label in ("background", "flower"):
            continue
        inter = union = tp = fn = 0
        for i, f in enumerate(rgb_files):
            gt = iio.imread(f.replace("_rgb", f"_{label}")) > 0
            pm = pred[i] == li
            inter += int((gt & pm).sum())
            union += int((gt | pm).sum())
            tp += int((gt & pm).sum())
            fn += int((gt & ~pm).sum())
        out[label] = {"iou": round(inter / max(union, 1), 4),
                      "recall": round(tp / max(tp + fn, 1), 4)}
    inter = union = 0
    for i, f in enumerate(rgb_files):
        gt = np.zeros(pred[i].shape, bool)
        for label in LABELS:
            if label in ("background", "flower"):
                continue
            gt |= iio.imread(f.replace("_rgb", f"_{label}")) > 0
        pm = pred[i] != 0
        inter += int((gt & pm).sum())
        union += int((gt | pm).sum())
    out["plant"] = {"iou": round(inter / max(union, 1), 4)}
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="unet_seg_trained.npz",
                    help="checkpoint path (default: in the current "
                         "directory)")
    ap.add_argument("--steps", type=int, default=3000)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--widths", default="24,48,96,192")
    ap.add_argument("--arch", default="resunet",
                    choices=["resunet", "tpusegnet"])
    ap.add_argument("--crop", type=int, default=448)
    ap.add_argument("--n-procedural", type=int, default=12)
    ap.add_argument("--views-per-plant", type=int, default=18)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--dataset-cache", default="")
    ap.add_argument("--skip-fixture-eval", action="store_true")
    ap.add_argument("--checkpoint-every", type=int, default=0,
                    help="save training state every N steps (rounded to "
                         "chunks) beside --out; interrupted runs resume "
                         "from it automatically")
    ap.add_argument("--fresh", action="store_true",
                    help="ignore any existing training state")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the "
                         "kernels' plain versions)")
    args = ap.parse_args(argv)

    from .checkpoint import flax_params, params_to_npz_bytes

    if args.dataset_cache and Path(args.dataset_cache).exists():
        z = np.load(args.dataset_cache)
        rgb, lab = z["rgb"], z["lab"]
        meta = json.loads(str(z["meta"]))
        logger.info(f"loaded cached dataset {rgb.shape}")
    else:
        rgb, lab, meta = build_training_set(
            n_procedural=args.n_procedural,
            views_per_plant=args.views_per_plant,
            crop=args.crop, seed=args.seed)
        if args.dataset_cache:
            np.savez_compressed(args.dataset_cache, rgb=rgb, lab=lab,
                                meta=json.dumps(meta))

    widths = tuple(int(x) for x in args.widths.split(","))
    if args.arch == "tpusegnet" and args.widths == "24,48,96,192":
        widths = (128, 256, 256)    # the TPU-shaped default

    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    state_path = Path(args.out).with_suffix(".trainstate.npz")
    resume_state = None
    if args.checkpoint_every and not args.fresh and state_path.exists():
        resume_state = state_path.read_bytes()
        logger.info(f"found training state {state_path} — resuming")

    def on_checkpoint(blob, chunk):
        tmp = state_path.with_suffix(".tmp")
        tmp.write_bytes(blob)
        tmp.replace(state_path)     # atomic: a kill never truncates
        logger.info(f"checkpointed training state at chunk {chunk}")

    every_chunks = max(args.checkpoint_every // STEPS_PER_CALL, 1) \
        if args.checkpoint_every else 0
    model, config, history = train_on_crops(
        rgb, lab, widths=widths, steps=args.steps,
        batch_size=args.batch_size, lr=args.lr, seed=args.seed,
        arch=args.arch,
        checkpoint_every_chunks=every_chunks,
        on_checkpoint=on_checkpoint if every_chunks else None,
        resume_state=resume_state, device=args.device)
    if state_path.exists():
        state_path.unlink()         # completed — state is stale now
    config["dataset"] = meta
    params16 = _half(flax_params(model))

    if not args.skip_fixture_eval:
        # inference casts the model it is given: evaluate a copy
        fx = evaluate_on_fixture(copy.deepcopy(model))
        if fx:
            config["fixture_eval"] = fx
            logger.info(f"fixture-render IoU: {fx}")

    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_bytes(params_to_npz_bytes(params16, config))
    hist_path = out.with_suffix(".history.json")
    hist_path.write_text(json.dumps(
        {"history": history, "config": config}, indent=2))
    logger.info(f"saved {out} ({out.stat().st_size / 1e6:.1f} MB) + "
                f"{hist_path.name}")
    return 0


def _half(tree):
    """Float leaves of a flax tree as float16 (the stored checkpoint)."""
    return {k: _half(v) if isinstance(v, dict)
            else v.astype(np.float16) if np.issubdtype(v.dtype, np.floating)
            else v for k, v in tree.items()}


if __name__ == "__main__":
    import sys
    sys.exit(main())
