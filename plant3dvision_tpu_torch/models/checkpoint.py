"""Model checkpoint loading (port of plant3dvision_tpu/models/checkpoint.py,
NPZ part).

Format: NPZ of '/'-joined flattened flax parameter paths (+ a JSON
`__config__` entry), loadable with numpy alone. `state_dict_from_flax`
carries a flax parameter tree over to the port's `nn.Module`s: a conv
kernel goes from HWIO to OIHW, a GroupNorm `scale` becomes `weight`, and
flax's module auto-names are the port's submodule names.

Torch `.pt` checkpoints (the reference's ResUNet format) come with the
port's ResUNet, in the separate-task ML slice.
"""

from __future__ import annotations

import json
from io import BytesIO

import numpy as np


def params_from_npz_bytes(data: bytes):
    """(nested params dict of numpy arrays, config dict) of an NPZ blob."""
    loaded = np.load(BytesIO(data), allow_pickle=False)
    config, params = {}, {}
    for k in loaded.files:
        if k == "__config__":
            config = json.loads(bytes(loaded[k]).decode())
            continue
        node = params
        *path, leaf = k.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = loaded[k]
    return params, config


def _upcast_f16(params):
    """float16 leaves -> float32 (checkpoints may be stored halved)."""
    return {k: (_upcast_f16(v) if isinstance(v, dict)
                else v.astype(np.float32) if v.dtype == np.float16 else v)
            for k, v in params.items()}


def state_dict_from_flax(params) -> dict:
    """flax parameter tree (numpy leaves; the top-level "params" collection
    may be present) -> a torch state_dict of the port's module."""
    import torch

    if set(params) == {"params"}:
        params = params["params"]
    out = {}

    def walk(node, prefix):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, prefix + k + ".")
                continue
            a = np.asarray(v)
            if k == "kernel":
                if a.ndim != 4:
                    raise ValueError(f"{prefix}kernel: expected an HWIO conv "
                                     f"kernel, got shape {a.shape}")
                out[prefix + "weight"] = torch.from_numpy(
                    np.ascontiguousarray(a.transpose(3, 2, 0, 1)))
            elif k == "scale":
                out[prefix + "weight"] = torch.from_numpy(a.copy())
            elif k == "bias":
                out[prefix + "bias"] = torch.from_numpy(a.copy())
            else:
                raise ValueError(f"unknown flax parameter {prefix}{k}")

    walk(params, "")
    return out


def model_from_config(config: dict):
    """The architecture a checkpoint's config describes ('arch':
    'tpusegnet'; 'resunet', the JAX package's default, is not ported yet)."""
    from .unet import SEGMENTATION_LABELS
    labels = config.get("label_names") or SEGMENTATION_LABELS
    arch = config.get("arch", "resunet")
    if arch != "tpusegnet":
        raise NotImplementedError(
            f"model arch {arch!r} is not ported yet: the port runs "
            "TPUSegNet ('arch': 'tpusegnet'); ResUNet comes with the "
            "separate-task ML route (Segmentation2D)")
    from .segnet import TPUSegNet
    return TPUSegNet(n_classes=len(labels),
                     widths=tuple(config.get("widths", (128, 256, 256))),
                     blocks_per_stage=int(config.get("blocks_per_stage", 2)),
                     patch=int(config.get("patch", 4)))


def load_model(file):
    """(model, config) from an fsdb File holding an NPZ checkpoint: the
    model (an `nn.Module` on the CPU) holds the checkpoint's weights, upcast
    from float16 to float32."""
    fname = getattr(file, "filename", "") or ""
    if fname.endswith((".pt", ".pth")):
        raise NotImplementedError(
            f"{fname}: torch .pt checkpoints (ResUNet) are not ported yet; "
            "the port loads NPZ checkpoints")
    params, config = params_from_npz_bytes(file.read_raw())
    model = model_from_config(config)
    model.load_state_dict(state_dict_from_flax(_upcast_f16(params)))
    return model, config
