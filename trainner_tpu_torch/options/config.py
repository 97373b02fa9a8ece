"""Options: parse a YAML/JSON options file into a NoneDict config tree.

Counterpart of ``trainner_tpu/options/config.py`` (``parse:255``,
``parse_dict:266``, ``parse_datasets:195``, ``INTERP_CODES:113``). JSON
options (with ``//`` comments) need nothing beyond the standard library;
``yaml`` is imported only when a YAML file is read. A train dataset gets its
degradation preset overlay (``options/presets``) before its resize algorithm
names are mapped to the reference's integer codes.

Not ported yet (ROADMAP Queue A 8, "the torch CLI trainer"): network
presets, ``use_unshuffle`` and ``*_rel`` training schedules. Asking for one
raises.
"""

from __future__ import annotations

import json
import os
import re

from . import presets as _presets
from .defaults import get_network_defaults

__all__ = ["INTERP_CODES", "NoneDict", "dict_to_nonedict", "parse",
           "parse_dict", "read_json", "read_yaml"]


class NoneDict(dict):
    """dict that returns None for missing keys."""

    def __missing__(self, key):
        return None


def dict_to_nonedict(opt):
    if isinstance(opt, dict):
        return NoneDict((k, dict_to_nonedict(v)) for k, v in opt.items())
    if isinstance(opt, list):
        return [dict_to_nonedict(x) for x in opt]
    return opt


# YAML 1.1 reads "5e3" as a string; this resolver reads scientific notation
# without a dot as a float, as the JAX package's loader does.
_SCI_RE = re.compile(
    r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+]?[0-9]+)?
    |[-+]?(?:[0-9][0-9_]*)(?:[eE][-+]?[0-9]+)
    |\.[0-9_]+(?:[eE][-+][0-9]+)?
    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
    |[-+]?\.(?:inf|Inf|INF)
    |\.(?:nan|NaN|NAN))$""",
    re.X,
)


def read_yaml(path: str) -> dict:
    import yaml

    class _OptLoader(yaml.SafeLoader):
        pass

    _OptLoader.add_implicit_resolver("tag:yaml.org,2002:float", _SCI_RE,
                                     list("-+0123456789."))
    with open(path, "r") as f:
        return yaml.load(f.read(), Loader=_OptLoader)


def read_json(path: str) -> dict:
    """JSON options; text after ``//`` on a line is a comment."""
    with open(path, "r") as f:
        lines = f.readlines()
    txt = "".join(ln.split("//")[0] + ("\n" if "//" in ln else "")
                  for ln in lines)
    return json.loads(txt)


def load_file(path: str) -> dict:
    ext = os.path.splitext(path)[1].lower()
    if ext in (".yml", ".yaml"):
        return read_yaml(path)
    if ext == ".json":
        return read_json(path)
    raise ValueError(f"Unknown options file extension: {path}")


# The reference's integer codes: 0-6 are cv2 methods, 77x the MATLAB-style
# antialiased kernels of ops/imresize, 997/998/999 special dispatch.
# 'linear' and 'cubic' are the antialiased kernels (773, 777), not cv2's.
INTERP_CODES = {
    "cv2_nearest": 0, "nearest": 0, "cv2_linear": 1, "cv2_cubic": 2,
    "cv2_area": 3, "area": 3, "cv2_lanczos4": 4, "cv2_linear_exact": 5,
    "linear": 773, "bilinear": 773, "box": 774, "lanczos2": 775,
    "lanczos3": 776, "cubic": 777, "bicubic": 777, "matlab_bicubic": 777,
    "mitchell": 778, "hermite": 779, "lanczos4": 780, "lanczos5": 781,
    "bell": 782, "catrom": 783, "hanning": 784, "hamming": 785,
    "gaussian": 786, "sinc2": 787, "sinc3": 788, "sinc4": 789, "sinc5": 790,
    "blackman2": 791, "blackman3": 792, "blackman4": 793, "blackman5": 794,
    "nearest_aligned": 997, "down_up": 998, "realistic": 999,
    "matlab_nearest": 774, "matlab_box": 774, "matlab_linear": 773,
    "matlab_bilinear": 773, "matlab_lanczos2": 775, "matlab_lanczos3": 776,
}
_ALGO_KEYS = ("lr_downscale_types", "lr_downscale_types2",
              "hr_downscale_types", "final_scale_types", "down_up_types",
              "resize_algos")


def _algo2int(value):
    if isinstance(value, str):
        return INTERP_CODES.get(value.lower(), value)
    if isinstance(value, (list, tuple)):
        return [_algo2int(v) for v in value]
    return value


_DATAROOT_ALIASES = {
    "dataroot_HR": ("dataroot_HR", "dataroot_B", "dataroot_gt",
                    "dataroot_target"),
    "dataroot_LR": ("dataroot_LR", "dataroot_A", "dataroot_lq",
                    "dataroot_input"),
}


def _expand_paths(val):
    if isinstance(val, str):
        return os.path.expanduser(val)
    if isinstance(val, list):
        return [_expand_paths(v) for v in val]
    return val


def parse_datasets(opt: dict, opt_path: str = "") -> None:
    scale = opt.get("scale", 1)
    for phase_key, dataset in (opt.get("datasets") or {}).items():
        phase = phase_key.split("_")[0]
        dataset["phase"] = phase
        dataset["scale"] = scale
        for canon, aliases in _DATAROOT_ALIASES.items():
            for a in aliases:
                if dataset.get(a) is not None:
                    dataset[canon] = dataset[a]
                    break
        if phase == "train":
            # the preset overlay lands before the algorithm names are mapped
            _presets.apply_presets(dataset, opt_path=opt_path)
        if dataset.get("HR_size") is not None and \
                dataset.get("crop_size") is None:
            dataset["crop_size"] = dataset["HR_size"]
        for k in ("dataroot_HR", "dataroot_LR"):
            if dataset.get(k) is not None:
                dataset[k] = _expand_paths(dataset[k])
                roots = dataset[k] if isinstance(dataset[k], list) \
                    else [dataset[k]]
                if any(str(r).endswith(".lmdb") for r in roots):
                    dataset["data_type"] = "lmdb"
        dataset.setdefault("data_type", "img")
        if phase == "train":
            bs = dataset.get("batch_size") or 1
            vbs = dataset.get("virtual_batch_size") or bs
            dataset["virtual_batch_size"] = max(vbs, bs)
        for k in _ALGO_KEYS:
            if dataset.get(k) is not None:
                dataset[k] = _algo2int(dataset[k])


def parse(opt_path: str, is_train: bool = True) -> NoneDict:
    """Parse an options file into a NoneDict config tree."""
    return parse_dict(load_file(opt_path), opt_path=opt_path,
                      is_train=is_train)


def parse_dict(opt: dict, opt_path: str = "",
               is_train: bool = True) -> NoneDict:
    for key in ("network_G_preset", "network_D_preset", "use_unshuffle"):
        if opt.get(key):
            raise NotImplementedError(
                f"option {key!r} is not ported yet (ROADMAP Queue A, "
                "the torch CLI trainer)")
    opt["is_train"] = is_train
    opt.setdefault("model", "sr")
    opt.setdefault("scale", 1)
    name = opt.get("name", "unnamed")
    if name.startswith("debug"):
        opt["is_debug"] = True
    parse_datasets(opt, opt_path=opt_path)
    get_network_defaults(opt)

    paths = {k: _expand_paths(v) for k, v in (opt.get("path") or {}).items()}
    root = os.path.expanduser(paths.get("root") or ".")
    if is_train:
        exp_root = os.path.join(root, "experiments", name)
        paths.setdefault("experiments_root", exp_root)
        paths.setdefault("models", os.path.join(exp_root, "models"))
        paths.setdefault("training_state",
                         os.path.join(exp_root, "training_state"))
        paths.setdefault("log", exp_root)
        paths.setdefault("val_images", os.path.join(exp_root, "val_images"))
    else:
        res_root = os.path.join(root, "results", name)
        paths.setdefault("results_root", res_root)
        paths.setdefault("log", res_root)
    opt["path"] = paths
    return dict_to_nonedict(opt)
