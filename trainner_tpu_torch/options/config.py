"""Options: parse a YAML/JSON options file into a NoneDict config tree.

Counterpart of ``trainner_tpu/options/config.py`` (``parse:255``,
``parse_dict:266``, ``parse_datasets:195``, ``_resolve_rel:235``,
``check_resume:320``, ``dict2str:348``, ``INTERP_CODES:113``). Neither
format needs anything beyond the standard library: JSON options may carry
``//`` comments, and ``read_yaml`` is the port's own reader of the YAML
that options files use (the card's machine has no PyYAML). A train dataset
gets its degradation preset overlay (``options/presets``) before its resize
algorithm names are mapped to the reference's integer codes; ``*_rel``
training keys become iterations (a fraction of ``niter``), and an
experiment whose name starts with ``debug`` gets the short frequencies.

Not ported yet, each raising with its ROADMAP item: the network presets
(``network_G_preset``, ``network_D_preset``) and ``use_unshuffle``.
"""

from __future__ import annotations

import json
import math
import os
import re
from typing import List

from . import presets as _presets
from .defaults import get_network_defaults

__all__ = ["INTERP_CODES", "NoneDict", "check_resume", "dict2str",
           "dict_to_nonedict", "parse", "parse_dict", "read_json",
           "read_yaml"]


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
# YAML 1.1's implicit types, in the order a safe loader tries them
_BOOL_RE = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False"
                      r"|FALSE|on|On|ON|off|Off|OFF)$")
_INT_RE = re.compile(r"""^(?:[-+]?0b[0-1_]+
    |[-+]?0[0-7_]+
    |[-+]?(?:0|[1-9][0-9_]*)
    |[-+]?0x[0-9a-fA-F_]+
    |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$""", re.X)
_NULL_RE = re.compile(r"^(?:~|null|Null|NULL|)$")


def _sexagesimal(text: str, cast):
    value, base = 0, 1
    for part in reversed(text.split(":")):
        value += cast(part) * base
        base *= 60
    return value


def _yaml_int(text: str) -> int:
    text = text.replace("_", "")
    sign = -1 if text[0] == "-" else 1
    text = text.lstrip("+-")
    if text == "0":
        return 0
    if text.startswith("0b"):
        return sign * int(text[2:], 2)
    if text.startswith("0x"):
        return sign * int(text[2:], 16)
    if text[0] == "0":
        return sign * int(text, 8)
    if ":" in text:
        return sign * _sexagesimal(text, int)
    return sign * int(text)


def _yaml_float(text: str) -> float:
    text = text.replace("_", "").lower()
    sign = -1.0 if text[0] == "-" else 1.0
    text = text.lstrip("+-")
    if text == ".inf":
        return sign * math.inf
    if text == ".nan":
        return math.nan
    if ":" in text:
        return sign * _sexagesimal(text, float)
    return sign * float(text)


def _yaml_scalar(text: str):
    """A plain or quoted YAML scalar, resolved as a YAML 1.1 safe loader
    with the scientific-notation resolver above resolves it."""
    text = text.strip()
    if text.startswith('"'):
        if len(text) < 2 or not text.endswith('"'):
            raise ValueError(f"unterminated string {text!r}")
        return json.loads(text)
    if text.startswith("'"):
        if len(text) < 2 or not text.endswith("'"):
            raise ValueError(f"unterminated string {text!r}")
        return text[1:-1].replace("''", "'")
    if _BOOL_RE.match(text):
        return text.lower() in ("yes", "true", "on")
    if _NULL_RE.match(text):
        return None
    if _INT_RE.match(text):
        return _yaml_int(text)
    if _SCI_RE.match(text):
        return _yaml_float(text)
    if text[:1] in ("&", "*", "!", "|", ">", "%", "@", "`"):
        raise ValueError(f"YAML feature not supported in options: {text!r}")
    return text


def _split_flow(text: str) -> List[str]:
    """The items of a flow collection's body, split at its top-level
    commas."""
    items, depth, quote, cur = [], 0, "", []
    for ch in text:
        if quote:
            quote = "" if ch == quote else quote
        elif ch in "\"'":
            quote = ch
        elif ch in "[{":
            depth += 1
        elif ch in "]}":
            depth -= 1
        elif ch == "," and depth == 0:
            items.append("".join(cur))
            cur = []
            continue
        cur.append(ch)
    items.append("".join(cur))
    return [t for t in items if t.strip()]


def _split_key(text: str):
    """(key, rest) of a ``key: value`` line, or None when the text is not a
    mapping entry. The separator is the first colon outside quotes and
    brackets that a space or the end of the line follows."""
    depth, quote = 0, ""
    for i, ch in enumerate(text):
        if quote:
            quote = "" if ch == quote else quote
        elif ch in "\"'" and (i == 0 or text[i - 1] in " [{,"):
            quote = ch
        elif ch in "[{":
            depth += 1
        elif ch in "]}":
            depth -= 1
        elif ch == ":" and depth == 0 and (i + 1 == len(text)
                                           or text[i + 1] in " \t"):
            return text[:i].strip(), text[i + 1:].strip()
    return None


def _yaml_value(text: str):
    """A scalar or a flow collection (``[a, b]``, ``{k: v}``)."""
    text = text.strip()
    if text.startswith("["):
        if not text.endswith("]"):
            raise ValueError(f"a flow list must end on its line: {text!r}")
        return [_yaml_value(t) for t in _split_flow(text[1:-1])]
    if text.startswith("{"):
        if not text.endswith("}"):
            raise ValueError(f"a flow map must end on its line: {text!r}")
        out = {}
        for item in _split_flow(text[1:-1]):
            kv = _split_key(item) or (item.strip(), "")
            out[_yaml_scalar(kv[0])] = _yaml_value(kv[1])
        return out
    return _yaml_scalar(text)


def _strip_comment(line: str) -> str:
    quote = ""
    for i, ch in enumerate(line):
        if quote:
            quote = "" if ch == quote else quote
        elif ch in "\"'" and (i == 0 or line[i - 1] in " [{,:"):
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i].rstrip()
    return line.rstrip()


def _open_brackets(text: str) -> int:
    depth, quote = 0, ""
    for ch in text:
        if quote:
            quote = "" if ch == quote else quote
        elif ch in "\"'":
            quote = ch
        elif ch in "[{":
            depth += 1
        elif ch in "]}":
            depth -= 1
    return depth


def _yaml_block(lines, i: int, indent: int):
    """The block collection whose first line is ``lines[i]``, at
    ``indent``; returns (value, index of the next line)."""
    if lines[i][1] == "-" or lines[i][1].startswith("- "):
        out_list = []
        while i < len(lines) and lines[i][0] == indent and (
                lines[i][1] == "-" or lines[i][1].startswith("- ")):
            rest = lines[i][1][1:].lstrip()
            if not rest:
                if i + 1 < len(lines) and lines[i + 1][0] > indent:
                    value, i = _yaml_block(lines, i + 1, lines[i + 1][0])
                else:
                    value, i = None, i + 1
            elif _split_key(rest) is not None or rest == "-" or \
                    rest.startswith("- "):
                # "- key: value" ("- - item"): a mapping (a list) whose
                # entries line up with its first
                sub = indent + len(lines[i][1]) - len(rest)
                lines[i] = (sub, rest)
                value, i = _yaml_block(lines, i, sub)
            else:
                value, i = _yaml_value(rest), i + 1
            out_list.append(value)
        return out_list, i
    out: dict = {}
    while i < len(lines) and lines[i][0] == indent:
        kv = _split_key(lines[i][1])
        if kv is None:
            raise ValueError(f"not a mapping entry: {lines[i][1]!r}")
        key, rest = _yaml_scalar(kv[0]), kv[1]
        i += 1
        if rest:
            out[key] = _yaml_value(rest)
        elif i < len(lines) and (lines[i][0] > indent or (
                lines[i][0] == indent and lines[i][1].startswith("-"))):
            out[key], i = _yaml_block(lines, i, lines[i][0])
        else:
            out[key] = None
    return out, i


def read_yaml(path: str) -> dict:
    """An options file in YAML, read without PyYAML (the card's machine has
    none): block maps and lists by indentation, ``[a, b]`` and ``{k: v}``
    flow collections (over several lines too), quoted and plain scalars
    with YAML 1.1's types (``yes``/``on`` are booleans, ``~`` is null, a
    leading 0 is octal), ``#`` comments, and ``1e-4`` as a float, as the
    JAX package's loader reads it. Anchors, tags, multi-document files and
    multi-line scalars raise."""
    lines = []
    with open(path, "r") as f:
        for raw in f:
            if raw.strip() in ("---", "..."):
                continue
            if "\t" in raw[:len(raw) - len(raw.lstrip())]:
                raise ValueError(f"{path}: tab in indentation")
            line = _strip_comment(raw.rstrip("\n"))
            if not line.strip():
                continue
            if lines and _open_brackets(lines[-1][1]) > 0:
                # a flow collection that goes on over several lines
                lines[-1] = (lines[-1][0], lines[-1][1] + " " + line.strip())
            else:
                lines.append((len(line) - len(line.lstrip()),
                              line.strip()))
    if not lines:
        return None
    value, i = _yaml_block(lines, 0, lines[0][0])
    if i != len(lines):
        raise ValueError(f"{path}: bad indentation near {lines[i][1]!r}")
    return value


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


def _resolve_rel(train_opt: dict) -> None:
    """``<key>_rel`` (a fraction of ``niter``, or a list of them) ->
    ``<key>`` in iterations, rounded; the ``_rel`` key goes."""
    niter = train_opt.get("niter")
    if not niter:
        return
    niter = int(niter)
    for key in list(train_opt.keys()):
        if key.endswith("_rel"):
            base = key[: -len("_rel")]
            val = train_opt[key]
            if isinstance(val, (list, tuple)):
                train_opt[base] = [int(round(v * niter)) for v in val]
            elif isinstance(val, (int, float)):
                train_opt[base] = int(round(val * niter))
            del train_opt[key]


# option -> the ROADMAP item that ports it
_NOT_PORTED = {
    "network_G_preset": "Queue A 8.1, the network presets",
    "network_D_preset": "Queue A 8.1, the network presets",
    "use_unshuffle": "Queue A 8.2, the pixel-unshuffle wrapper",
}


def parse(opt_path: str, is_train: bool = True) -> NoneDict:
    """Parse an options file into a NoneDict config tree."""
    return parse_dict(load_file(opt_path), opt_path=opt_path,
                      is_train=is_train)


def parse_dict(opt: dict, opt_path: str = "",
               is_train: bool = True) -> NoneDict:
    for key, item in _NOT_PORTED.items():
        if opt.get(key):
            raise NotImplementedError(
                f"option {key!r} is not ported yet (ROADMAP {item})")
    opt["is_train"] = is_train
    opt.setdefault("model", "sr")
    opt.setdefault("scale", 1)
    name = opt.get("name", "unnamed")
    if name.startswith("debug"):
        # short frequencies for a smoke run of the training CLI
        opt["is_debug"] = True
        train = opt.get("train") or {}
        logger = opt.get("logger") or {}
        train["val_freq"] = 8
        logger["print_freq"] = 2
        logger["save_checkpoint_freq"] = 10**8 if "nochkp" in name else 8
        opt["train"], opt["logger"] = train, logger
    parse_datasets(opt, opt_path=opt_path)
    get_network_defaults(opt)
    if opt.get("train"):
        _resolve_rel(opt["train"])

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


def check_resume(opt: dict, resume_iter: int) -> None:
    """Points ``pretrain_model_G`` and ``pretrain_model_D`` at the
    checkpoints of the iteration a resume starts from
    (``{models}/{iter}_G.ckpt``, ``{iter}_D.ckpt``)."""
    paths = opt["path"]
    if not paths.get("resume_state"):
        return
    for n in ("G", "D"):
        paths[f"pretrain_model_{n}"] = os.path.join(
            paths.get("models"), f"{resume_iter}_{n}.ckpt")


def dict2str(opt: dict, indent_l: int = 1) -> str:
    """The options as indented text, for the log."""
    msg = ""
    for k, v in opt.items():
        if isinstance(v, dict):
            msg += " " * (indent_l * 2) + k + ":[\n"
            msg += dict2str(v, indent_l + 1)
            msg += " " * (indent_l * 2) + "]\n"
        else:
            msg += " " * (indent_l * 2) + k + ": " + str(v) + "\n"
    return msg
