"""Model checkpoints (port of plant3dvision_tpu/models/checkpoint.py: the
NPZ writer and loader, the training states and the torch `.pt` path).

Format: NPZ of '/'-joined flattened flax parameter paths (+ a JSON
`__config__` entry), loadable with numpy alone. `state_dict_from_flax`
carries a flax parameter tree over to the port's `nn.Module`s: a conv
kernel goes from HWIO to OIHW, a GroupNorm `scale` becomes `weight`, and
flax's module auto-names are the port's submodule names.

Torch `.pt`/`.pth` checkpoints (the reference's ResUNet format) go through
the JAX package's converter contract (`convert_torch_state_dict`) into a
flax-layout tree, against a template that the port's module enumerates in
flax's traversal order (`flax_template`), then through
`state_dict_from_flax`; BatchNorm running statistics are folded into a
`norm="affine"` ResUNet (`fold_batchnorm`).

The way back, `flax_params`, gives a port module's weights as the flax
tree (HWIO kernels, `scale`), so `params_to_npz_bytes` / `save_model`
write checkpoints that the JAX package's `load_model` reads, and
`training_state_to_npz_bytes` / `training_state_from_npz_bytes` the full
training states of both packages: `p/<flax path>` parameters, `o/<i>`
optimizer leaves in optax's order (models/optim.py:AdamW.state_leaves) and
a JSON `__meta__`.
"""

from __future__ import annotations

import json
import pickle
import warnings
from io import BytesIO

import numpy as np


def params_from_npz_bytes(data: bytes):
    """(nested params dict of numpy arrays, config dict) of an NPZ blob."""
    loaded = np.load(BytesIO(data), allow_pickle=False)
    config = {}
    if "__config__" in loaded.files:
        config = json.loads(bytes(loaded["__config__"]).decode())
    return _unflatten({k: loaded[k] for k in loaded.files
                       if k != "__config__"}), config


def flax_params(model) -> dict:
    """A port module's parameters as the flax tree {"params": {...}} of
    float32 numpy arrays (conv weights OIHW -> HWIO kernels, norm weights
    -> `scale`); the inverse of `state_dict_from_flax`."""
    flat = {}
    for (path, _), p in zip(flax_template(model).items(),
                            model.parameters()):
        a = p.detach().to("cpu", copy=True).float().numpy()
        flat[path] = np.ascontiguousarray(a.transpose(2, 3, 1, 0)) \
            if a.ndim == 4 else a
    return _unflatten(flat)


def params_to_npz_bytes(params, config: dict) -> bytes:
    """NPZ blob of a flax parameter tree ('/'-joined paths) and its JSON
    config (`__config__`), the JAX package's checkpoint format."""
    arrays = {k: np.asarray(v) for k, v in _flatten(params).items()}
    arrays["__config__"] = np.frombuffer(json.dumps(config).encode(),
                                         dtype=np.uint8)
    buf = BytesIO()
    np.savez_compressed(buf, **arrays)
    return buf.getvalue()


def save_model(file, params, config: dict):
    """Write a model checkpoint (a flax tree, e.g. `flax_params(model)`)
    into an fsdb File, with its label_names and config as metadata."""
    file.write_raw(params_to_npz_bytes(params, config), "npz")
    file.set_metadata("label_names", config.get("label_names"))
    file.set_metadata("model_config", config)


def training_state_to_npz_bytes(params, opt_leaves, meta: dict) -> bytes:
    """One NPZ blob of a full training state: the flax parameter tree as
    `p/<path>`, the optimizer's leaves in optax's order as `o/<i>`, and the
    JSON-serialisable loop metadata `meta` (the JAX package's layout)."""
    arrays = {"p/" + k: np.asarray(v) for k, v in _flatten(params).items()}
    for i, leaf in enumerate(opt_leaves):
        arrays[f"o/{i}"] = np.asarray(leaf)
    arrays["__meta__"] = np.frombuffer(json.dumps(meta).encode(),
                                       dtype=np.uint8)
    buf = BytesIO()
    np.savez_compressed(buf, **arrays)
    return buf.getvalue()


def training_state_from_npz_bytes(data: bytes):
    """(flax parameter tree, optimizer leaves in order, meta) of a
    training state blob (either package's)."""
    loaded = np.load(BytesIO(data), allow_pickle=False)
    meta = json.loads(bytes(loaded["__meta__"]).decode())
    params = _unflatten({k[2:]: loaded[k] for k in loaded.files
                         if k.startswith("p/")})
    n = sum(1 for k in loaded.files if k.startswith("o/"))
    return params, [loaded[f"o/{i}"] for i in range(n)], meta


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
    """Instantiate the architecture a checkpoint's config describes
    ('arch': 'resunet' (default, romiseg-parity) or 'tpusegnet')."""
    from .unet import SEGMENTATION_LABELS, ResUNet
    labels = config.get("label_names") or SEGMENTATION_LABELS
    if config.get("arch", "resunet") == "tpusegnet":
        from .segnet import TPUSegNet
        return TPUSegNet(n_classes=len(labels),
                         widths=tuple(config.get("widths", (128, 256, 256))),
                         blocks_per_stage=int(config.get("blocks_per_stage",
                                                         2)),
                         patch=int(config.get("patch", 4)))
    return ResUNet(n_classes=len(labels),
                   widths=tuple(config.get("widths", (64, 128, 256, 512))),
                   blocks_per_stage=int(config.get("blocks_per_stage", 2)),
                   norm=config.get("norm", "group"))


def load_model(file):
    """(model, config) from an fsdb File: the model (an `nn.Module` on the
    CPU) holds the checkpoint's weights, in float32.

    Native checkpoints are NPZ, possibly stored float16. A torch
    `.pt`/`.pth` file takes its config from the file's `model_config`
    metadata (`label_names` from the metadata of that name if the config
    has none) and goes through `load_torch_model`."""
    fname = getattr(file, "filename", "") or ""
    data = file.read_raw()
    if fname.endswith((".pt", ".pth")):
        config = dict(file.get_metadata("model_config") or {})
        if not config.get("label_names"):
            config["label_names"] = file.get_metadata("label_names")
        return load_torch_model(_torch_bytes_to_state_dict(data, fname),
                                config)
    params, config = params_from_npz_bytes(data)
    model = model_from_config(config)
    model.load_state_dict(state_dict_from_flax(_upcast_f16(params)))
    return model, config


def _torch_bytes_to_state_dict(data: bytes, name: str = "<bytes>"):
    """Tensors of a torch checkpoint as numpy arrays, in the file's order.

    It is loaded with `weights_only=True` first. A file that holds more
    than tensors (a pickled module) fails that with
    `pickle.UnpicklingError`; only then is it loaded again with
    `weights_only=False`, which runs its pickle (the reference's own
    `torch.load`), with a warning that names the file. Any other error (a
    corrupt or truncated file) is raised as it is."""
    import torch
    try:
        obj = torch.load(BytesIO(data), map_location="cpu", weights_only=True)
    except pickle.UnpicklingError as e:
        warnings.warn(f"{name}: not a weights-only torch checkpoint ({e}); "
                      "loading it with weights_only=False runs its pickle")
        obj = torch.load(BytesIO(data), map_location="cpu",
                         weights_only=False)
    if hasattr(obj, "state_dict"):
        obj = obj.state_dict()
    if isinstance(obj, dict):
        for key in ("state_dict", "model_state_dict", "model"):
            inner = obj.get(key)
            if isinstance(inner, dict) and inner and all(
                    hasattr(v, "shape") for v in inner.values()):
                obj = inner
                break
    return {k: np.asarray(v) for k, v in obj.items() if hasattr(v, "shape")}


def load_torch_model(state_dict, config: dict):
    """(model, config) from a torch state_dict of a MATCHING architecture
    (the converter contract of `convert_torch_state_dict`). BatchNorm
    checkpoints are folded into a `norm="affine"` ResUNet."""
    has_bn = any(k.endswith(".running_mean") for k in state_dict)
    cfg = dict(config)
    if has_bn:
        if cfg.get("arch", "resunet") != "resunet":
            raise ValueError(
                "BatchNorm folding targets the ResUNet norm='affine' "
                f"variant; arch={cfg.get('arch')!r} has no affine norm "
                "slot (folded stats would land in GroupNorm params and "
                "be re-normalized at apply time)")
        cfg["norm"] = "affine"
    model = model_from_config(cfg)
    params = convert_torch_state_dict(state_dict, flax_template(model),
                                      fold_bn=has_bn)
    model.load_state_dict(state_dict_from_flax(_upcast_f16(params)))
    return model, cfg


def flax_template(model) -> dict:
    """The flat flax parameter template of a port module: '/'-joined flax
    paths ('params/ResBlock_0/Conv_0/kernel', ...) -> zero arrays of the
    flax shapes (HWIO kernels), in flax's traversal order (the modules
    register their parameters in flax's creation order, weight before
    bias, under flax's names)."""
    out = {}
    for name, p in model.named_parameters():
        *path, leaf = name.split(".")
        if leaf == "weight" and p.ndim == 4:
            o, i, kh, kw = p.shape
            leaf, shape = "kernel", (kh, kw, i, o)
        else:
            leaf = "scale" if leaf == "weight" else leaf
            shape = tuple(p.shape)
        out["/".join(["params", *path, leaf])] = np.zeros(shape, np.float32)
    return out


#: torch bookkeeping tensors that have no flax counterpart and are safe
#: to drop silently (BatchNorm step counters)
_TORCH_IGNORABLE = ("num_batches_tracked",)
#: torch tensors that CARRY STATE a GroupNorm-based model cannot absorb —
#: dropping them changes semantics, so strict mode refuses
_TORCH_STATEFUL = ("running_mean", "running_var")


def _torch_kind(tk: str, tv) -> str:
    """Classify a torch tensor: 'bias' / 'scale' (1-D norm weight) /
    'kernel' (conv/linear weight)."""
    leaf = tk.rsplit(".", 1)[-1]
    if leaf == "bias":
        return "bias"
    if tv.ndim <= 1:
        return "scale"
    return "kernel"


def _flax_kind(k: str, tmpl) -> str:
    leaf = k.rsplit("/", 1)[-1]
    if leaf in ("bias", "scale"):
        return leaf
    if np.asarray(tmpl).ndim <= 1:
        return "scale"   # other 1-D leaves behave like norm params
    return "kernel"


def fold_batchnorm(state_dict, eps: float = 1e-5):
    """Fold torch BatchNorm running statistics into inference affines:
    for every `<p>.running_mean` / `<p>.running_var` pair, `<p>.weight` /
    `<p>.bias` become scale' = gamma / sqrt(var + eps) and bias' = beta -
    mean * scale' (gamma = 1, beta = 0 synthesized for affine=False
    BatchNorms); the running stats and step counters are dropped. Key order
    is preserved (the converter matches in traversal order). `eps` is the
    torch module's (BatchNorm2d: 1e-5)."""
    prefixes = {k[: -len(".running_mean")] for k in state_dict
                if k.endswith(".running_mean")}
    out = {}
    for k, v in state_dict.items():
        p, _, leaf = k.rpartition(".")
        if p in prefixes:
            if leaf == "running_mean":      # anchor: emit the folded pair
                mean = np.asarray(state_dict[f"{p}.running_mean"],
                                  np.float32)
                var = np.asarray(state_dict[f"{p}.running_var"], np.float32)
                gamma = (np.asarray(state_dict[f"{p}.weight"], np.float32)
                         if f"{p}.weight" in state_dict
                         else np.ones_like(mean))
                beta = (np.asarray(state_dict[f"{p}.bias"], np.float32)
                        if f"{p}.bias" in state_dict
                        else np.zeros_like(mean))
                scale = gamma / np.sqrt(var + eps)
                out[f"{p}.weight"] = scale
                out[f"{p}.bias"] = beta - mean * scale
            elif leaf in ("weight", "bias", "running_var",
                          "num_batches_tracked"):
                continue                     # consumed by the fold
            else:
                out[k] = v
        else:
            out[k] = v
    return out


def convert_torch_state_dict(state_dict, param_template, strict=True,
                             fold_bn=False, bn_eps=1e-5):
    """Torch -> flax weight mapping for matching architectures (the JAX
    package's contract):

    - tensors match by (kind, shape) in traversal order: the torch state
      dict's module-definition order against the flax template's order;
    - KIND gate: torch '.bias' only maps to flax 'bias'; 1-D '.weight'
      (norm scales) only to flax 'scale'; >=2-D '.weight' only to flax
      'kernel';
    - conv kernels transpose OIHW -> HWIO; linear weights (out, in) -> (in,
      out), square ones included;
    - `strict=True`: an unmatched flax param raises, and so do leftover
      torch tensors that carry state the target has no slot for (BatchNorm
      running statistics); `fold_bn=True` folds them first
      (`fold_batchnorm`), `strict=False` drops leftovers with a warning.

    `param_template` is a flax tree (nested dicts) or its flat '/'-joined
    form (`flax_template`); returns the nested flax tree of numpy arrays.
    """
    if fold_bn:
        state_dict = fold_batchnorm(state_dict, eps=bn_eps)
    torch_items = [(k, np.asarray(v)) for k, v in state_dict.items()
                   if hasattr(v, "shape")
                   and not k.rsplit(".", 1)[-1].startswith(_TORCH_IGNORABLE)]
    flat = _flatten(param_template)
    used = set()
    out = {}
    for k, tmpl in flat.items():
        shape = tuple(np.asarray(tmpl).shape)
        want = _flax_kind(k, tmpl)
        found = None
        for i, (tk, tv) in enumerate(torch_items):
            if i in used or _torch_kind(tk, tv) != want:
                continue
            tshape = tuple(tv.shape)
            if len(tshape) == 4:
                # conv: only the OIHW -> HWIO reading is valid
                if (tshape[2], tshape[3], tshape[1], tshape[0]) == shape:
                    found = (i, np.transpose(tv, (2, 3, 1, 0)))
                    break
            elif len(tshape) == 2 and want == "kernel":
                if tshape[::-1] == shape:
                    found = (i, tv.T)
                    break
            elif tshape == shape:
                found = (i, tv)
                break
        if found is None:
            raise ValueError(
                f"No torch tensor matches param {k} kind={want} {shape}; "
                f"unconsumed torch tensors: "
                f"{[(tk, tuple(tv.shape)) for j, (tk, tv) in enumerate(torch_items) if j not in used][:8]}")
        used.add(found[0])
        out[k] = found[1]

    leftovers = [(tk, tuple(tv.shape))
                 for i, (tk, tv) in enumerate(torch_items) if i not in used]
    if leftovers:
        stateful = [t for t in leftovers
                    if t[0].rsplit(".", 1)[-1].startswith(_TORCH_STATEFUL)]
        if strict and stateful:
            raise ValueError(
                "torch checkpoint carries normalization state the target "
                f"architecture cannot absorb: {stateful[:8]}"
                " — the model normalizes differently (GroupNorm); pass "
                "fold_bn=True with a norm='affine' template (see "
                "load_torch_model), or strict=False to drop it")
        warnings.warn(f"convert_torch_state_dict: dropped {len(leftovers)} "
                      f"unmatched torch tensors, e.g. {leftovers[:4]}")
    return _unflatten(out)


def _flatten(tree, prefix=""):
    """Nested dict -> {'a/b/c': leaf}, in the tree's order (a flat dict is
    returned as it is)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, prefix + k + "/"))
        else:
            out[prefix + k] = v
    return out


def _unflatten(flat):
    """{'a/b/c': leaf} -> nested dict, in the keys' order."""
    out = {}
    for k, v in flat.items():
        node = out
        *path, leaf = k.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return out
