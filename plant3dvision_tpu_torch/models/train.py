"""UNet training pipeline (port of plant3dvision_tpu/models/train.py; role
of the reference's romiseg training, configs/training_seg.toml): train the
organ segmenter on labeled scans (images + per-label mask filesets).

The batch order is numpy's (`default_rng(seed).permutation` an epoch), as
the JAX package's, so a training state of either package resumes in the
other with the same batches. A step: the batch uploaded, the ResUNet (bf16
convolutions, float32 parameters), the class-weighted cross-entropy and
its backward (K21), `optax.adamw(lr)` over one parameter arena (K22),
with cuDNN's deterministic algorithms (models/train_synth.py). With more
than one rank (`use_mesh`, the JAX package's default) the step runs the
dp policy of parallel/train.py.

CLI:
    python -m plant3dvision_tpu_torch.models.train <db>/<scan> \
        --config configs/training_seg.toml [--gt-fileset gt_masks] \
        [--epochs 20] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from ..ops.training import weighted_cross_entropy
from ..runtime.log import configure_logger

logger = configure_logger(__name__)


def load_dataset(scan, gt_fileset="gt_masks", labels=None, max_images=None):
    """Stack (images, int labels) from a scan's images + GT mask filesets."""
    from ..fsdb import io

    images_fs = scan.get_fileset("images")
    gt_fs = scan.get_fileset(gt_fileset)
    if labels is None:
        labels = gt_fs.get_metadata("label_names")
    imgs, labs = [], []
    files = images_fs.get_files()
    if max_images:
        files = files[:max_images]
    for f in files:
        img = io.read_image(f)
        if img.ndim == 2:
            img = np.repeat(img[..., None], 3, axis=-1)
        shot = f.get_metadata("shot_id")
        lab = np.zeros(img.shape[:2], np.int32)
        for li, name in enumerate(labels):
            if name == "background":
                continue
            for g in gt_fs.get_files({"shot_id": shot, "channel": name}):
                lab[io.read_image(g) > 0] = li
        imgs.append(img[..., :3].astype(np.float32) / 255.0)
        labs.append(lab)
    return np.stack(imgs), np.stack(labs), list(labels)


def class_weights(labels_int, n_cls):
    """train's class weights (plants cover ~1% of pixels): the pixel total
    over max(freq, 1), normalised to sum to n_cls (float64, as the JAX
    package computes them before the float32 cast)."""
    freq = np.bincount(np.asarray(labels_int).ravel(),
                       minlength=n_cls).astype(float)
    w = freq.sum() / np.maximum(freq, 1.0)
    return w / w.sum() * n_cls


def _create_unet(seed, widths, blocks_per_stage, n_classes, dtype):
    """The ResUNet, initialised from `seed` as flax initialises it
    (train_synth.init_like_flax); on the CPU."""
    from .train_synth import _make_model
    return _make_model("resunet", seed, widths, blocks_per_stage,
                       n_classes=n_classes, dtype=dtype)


def train(images, labels_int, label_names, widths=(32, 64, 128),
          blocks_per_stage=1, epochs=20, batch_size=4, lr=3e-3, seed=0,
          log_every=10, checkpoint_every=0, on_checkpoint=None,
          resume_state=None, device="cuda", dtype=torch.bfloat16,
          use_mesh=True, mesh=None):
    """Train a ResUNet; returns (model, config, history).

    Every `checkpoint_every` epochs, `on_checkpoint(state_bytes, epoch)`
    receives the full serialized training state (params + optimizer
    moments + epoch + numpy RNG state, the JAX package's layout). Pass
    such a blob back as `resume_state` to continue: the RNG state replays
    the same batch order, so an interrupted-and-resumed run is
    bit-identical to an uninterrupted one.

    `use_mesh` with more than one rank (those of `mesh`, else one a card
    on the card, one on the CPU) runs each step over a {"dp", "tp"} mesh
    (parallel/train.py): the JAX package's `best_dp_tp(ranks)`, or
    `mesh`'s own layout where its axes are "dp" and "tp", with dp cut to
    the batch size; the batch split over dp in contiguous parts, the
    convolutions over tp, the parameters and moments resident on the
    ranks; the controller sends each step's batch."""
    from ..runtime.config import resolve_device
    from .checkpoint import (flax_params, state_dict_from_flax,
                             training_state_from_npz_bytes,
                             training_state_to_npz_bytes)
    from .optim import AdamW
    from ..parallel.mesh import best_dp_tp, default_ranks, make_mesh
    from .train_synth import deterministic_backward

    dev = resolve_device(device)
    n = images.shape[0]
    model = _create_unet(seed, tuple(widths), blocks_per_stage,
                         len(label_names), dtype)
    w = torch.tensor(class_weights(labels_int, len(label_names)),
                     dtype=torch.float32, device=dev)
    ranks = mesh.size if mesh is not None else default_ranks(dev)
    trainer = own_mesh = layout = None
    if use_mesh and ranks > 1:
        layout = (dict(mesh.shape) if mesh is not None
                  and set(mesh.axis_names) <= {"dp", "tp"}
                  else best_dp_tp(ranks))
        layout["dp"] = min(layout.get("dp", 1), int(batch_size))
    if layout is not None and layout["dp"] * layout.get("tp", 1) > 1:
        from ..parallel.train import MeshTrainer
        if mesh is None:
            mesh = own_mesh = make_mesh(layout, device=dev)
        elif mesh.shape != layout:
            mesh = mesh.view(layout)
        logger.info(f"sharded trainer: mesh {mesh.shape}")
        trainer = MeshTrainer(mesh, model, dict(lr=lr), weights=w.cpu())
    model.to(dev)
    opt = AdamW(model, lr) if trainer is None else None

    history = []
    rng = np.random.default_rng(seed)
    start_epoch = 0
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
        rng.bit_generator.state = meta["rng_state"]
        start_epoch = int(meta["epoch"]) + 1
        history = list(meta.get("history", []))
        logger.info(f"resumed training at epoch {start_epoch}")
    steps_per_epoch = max(n // batch_size, 1)
    with deterministic_backward():
        for epoch in range(start_epoch, epochs):
            order = rng.permutation(n)
            for s in range(steps_per_epoch):
                sel = order[s * batch_size:(s + 1) * batch_size]
                if len(sel) < batch_size:
                    sel = np.concatenate([sel, order[: batch_size - len(sel)]])
                x = torch.from_numpy(images[sel]).permute(0, 3, 1, 2)
                y = torch.from_numpy(labels_int[sel].astype(np.uint8))
                if trainer is not None:
                    loss = trainer.step(x.contiguous(), y)
                    continue
                x, y = x.to(dev), y.to(dev)
                opt.zero_grad()
                loss = weighted_cross_entropy(model(x.contiguous()), y, w)
                loss.backward()
                opt.step()
                loss = loss.detach()
            history.append(float(loss))
            if epoch % log_every == 0 or epoch == epochs - 1:
                logger.info(f"epoch {epoch}: loss={history[-1]:.4f}")
            if (checkpoint_every and on_checkpoint is not None
                    and (epoch + 1) % checkpoint_every == 0
                    and epoch + 1 < epochs):
                meta = {"epoch": epoch,
                        "rng_state": rng.bit_generator.state,
                        "history": history}
                state = (trainer.state() if trainer is not None
                         else (flax_params(model), opt.state_leaves()))
                on_checkpoint(training_state_to_npz_bytes(*state, meta),
                              epoch)
    if trainer is not None:
        trainer.params_into(model)
        trainer.close()
        if own_mesh is not None:
            own_mesh.close()

    config = {"label_names": label_names, "widths": list(widths),
              "blocks_per_stage": blocks_per_stage}
    return model, config, history


def resolve_training_config(config_path, cli_args):
    """Merge defaults < [Training] TOML section < explicit CLI flags
    (the reference binds its training preset the same way,
    configs/training_seg.toml)."""
    cfg = {"gt_fileset": "gt_masks", "epochs": 20, "batch_size": 4,
           "lr": 3e-3, "widths": "32,64,128", "model_id": "unet_seg",
           "max_images": None, "checkpoint_every": None}
    if config_path:
        from ..runtime.config import load_toml
        section = dict(load_toml(config_path).get("Training", {}))
        if "learning_rate" in section:
            section.setdefault("lr", section.pop("learning_rate"))
        cfg.update({k: v for k, v in section.items()
                    if k in cfg and v is not None})
    for k in cfg:
        v = cli_args.get(k)
        if v is not None:
            cfg[k] = v
    return cfg


def main(argv=None):
    from ..fsdb import FSDB
    from ..runtime.cli import parse_dataset
    from .checkpoint import flax_params, save_model

    ap = argparse.ArgumentParser()
    ap.add_argument("dataset", help="<db>/<scan> with images + GT masks")
    ap.add_argument("--config", default=None,
                    help="TOML preset with a [Training] section "
                         "(configs/training_seg.toml); CLI flags override")
    ap.add_argument("--gt-fileset", default=None)
    ap.add_argument("--epochs", type=int, default=None)
    ap.add_argument("--batch-size", type=int, default=None)
    ap.add_argument("--lr", type=float, default=None)
    ap.add_argument("--widths", default=None)
    ap.add_argument("--model-id", default=None)
    ap.add_argument("--max-images", type=int, default=None)
    ap.add_argument("--checkpoint-every", type=int, default=None,
                    help="save full training state every N epochs into "
                         "the models fileset; an interrupted run resumes "
                         "from the last state automatically")
    ap.add_argument("--fresh", action="store_true",
                    help="ignore any existing training state")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the "
                         "kernels' plain versions)")
    args = ap.parse_args(argv)

    cfg = resolve_training_config(args.config, vars(args))
    args.gt_fileset, args.model_id = cfg["gt_fileset"], cfg["model_id"]
    args.epochs, args.batch_size = int(cfg["epochs"]), int(cfg["batch_size"])
    args.lr, args.widths = float(cfg["lr"]), str(cfg["widths"])
    args.max_images = cfg.get("max_images")
    ckpt_every = int(cfg.get("checkpoint_every") or 0)

    db_path, scan_id = parse_dataset(args.dataset)
    db = FSDB(db_path)
    db.connect(unsafe=True)
    scan = db.get_scan(scan_id)
    images, labels_int, label_names = load_dataset(
        scan, args.gt_fileset, max_images=args.max_images)
    logger.info(f"dataset: {images.shape}, labels {label_names}")
    widths = tuple(int(x) for x in args.widths.split(","))

    models_fs = scan.get_fileset("models", create=True)
    state_id = f"{args.model_id}_trainstate"
    resume_state = None
    if not args.fresh:
        sf = models_fs.get_file(state_id)
        if sf is not None:
            resume_state = sf.read_raw()
            logger.info(f"found training state '{state_id}' — resuming")

    def on_checkpoint(blob, epoch):
        f = models_fs.get_file(state_id, create=True)
        f.write_raw(blob, "npz")
        f.set_metadata("epoch", epoch)
        logger.info(f"checkpointed training state at epoch {epoch}")

    model, config, history = train(
        images, labels_int, label_names, widths=widths, epochs=args.epochs,
        batch_size=args.batch_size, lr=args.lr,
        checkpoint_every=ckpt_every,
        on_checkpoint=on_checkpoint if ckpt_every else None,
        resume_state=resume_state, device=args.device)
    f = models_fs.get_file(args.model_id, create=True)
    save_model(f, flax_params(model), config)
    if models_fs.get_file(state_id) is not None:
        models_fs.delete_file(state_id)  # completed — state is stale now
    logger.info(f"saved model '{args.model_id}' (final loss {history[-1]:.4f})")
    db.disconnect()
    return 0


if __name__ == "__main__":
    sys.exit(main())
