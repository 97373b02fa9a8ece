"""Degradation preset overlay of a train dataset.

Counterpart of ``trainner_tpu/options/presets/__init__.py``
(``load_preset:45``, ``apply_presets:82``): a train dataset pulls three
preset axes (blur, resize, noise); the base preset of an axis is read first,
the strategy preset over it, and inline dataset keys win over both. Per-aug
configs land in ``dataset["aug_configs"]``; pipeline flags merge flat into
the dataset.

The presets live beside this file as JSON (the same content as the JAX
package's YAML files), so that reading one needs no PyYAML. Ported: the
``base_*``, ``bsrgan_*`` and ``resrgan_*`` files. Another strategy raises.

``apply_network_presets`` (``apply_network_presets:59``) overlays the
network presets ``gen_esrgan`` and ``disc_esrgan`` (or a preset file) on
``network_G`` / ``network_D``.
"""

from __future__ import annotations

import json
import os

_AXES = ("blur", "resize", "noise")
_PRESET_DIR = os.path.dirname(os.path.abspath(__file__))
PORTED_STRATEGIES = ("bsrgan", "resrgan")


def find_preset_file(name: str, opt_path: str = "") -> str | None:
    """A preset name or path -> its JSON file, or None."""
    if os.path.isabs(name) or os.sep in name:
        candidates = [name, name + ".json"]
    else:
        candidates = [os.path.join(_PRESET_DIR, name + ".json")]
        if opt_path:
            candidates.append(os.path.join(os.path.dirname(opt_path),
                                           "presets", name + ".json"))
    for c in candidates:
        if os.path.isfile(c):
            return c
    return None


def load_preset(name: str, opt_path: str = "") -> dict:
    """The config of one preset: ``{"pipeline": {...}, <aug>: {...}}``."""
    path = find_preset_file(name, opt_path)
    if path is None:
        raise FileNotFoundError(f"Preset not found: {name}")
    with open(path, "r") as f:
        data = json.load(f)
    if "pipeline" in data or "augs" in data:
        cfg = {"pipeline": data.get("pipeline") or {}}
        cfg.update(data.get("augs") or {})
        return cfg
    return data.get("config", {}) or {}


def apply_network_presets(opt: dict, opt_path: str = "") -> None:
    """``network_G_preset`` / ``network_D_preset`` (a preset name or a
    file) at the top level of the options: the preset's ``network_G`` /
    ``network_D`` values fill in, the inline keys win."""
    for net_key in ("network_G", "network_D"):
        name = opt.get(f"{net_key}_preset")
        if not name:
            continue
        preset_net = load_preset(str(name), opt_path).get(net_key)
        if not isinstance(preset_net, dict):
            raise ValueError(f"preset {name!r} has no {net_key} section")
        merged = dict(preset_net)
        inline = opt.get(net_key)
        if isinstance(inline, str):
            inline = {"type": inline}
        merged.update(inline or {})
        opt[net_key] = merged


def apply_presets(dataset: dict, opt_path: str = "") -> None:
    """Applies the preset overlays to a train dataset's options in place."""
    strategy = dataset.get("augs_strategy")
    if not (strategy or any(dataset.get(f"add_{ax}_preset") for ax in _AXES)):
        return
    if strategy and strategy not in PORTED_STRATEGIES:
        raise NotImplementedError(
            f"augs_strategy [{strategy}] is not ported yet (ROADMAP Queue A "
            "5.2, the other preset strategies)")

    inline_cfgs = {k: dict(v)
                   for k, v in (dataset.get("aug_configs") or {}).items()
                   if isinstance(v, dict)}
    merged_cfgs: dict[str, dict] = {}
    merged_pipeline: dict = {}
    for ax in _AXES:
        base_name = dataset.get(f"base_{ax}_preset") or f"base_{ax}"
        strat_name = dataset.get(f"add_{ax}_preset") or (
            f"{strategy}_{ax}" if strategy else None)
        for name in (base_name, strat_name):  # base first, strategy over it
            if not name:
                continue
            cfg = load_preset(name, opt_path)
            merged_pipeline.update(cfg.get("pipeline") or {})
            for aug_name, aug_cfg in cfg.items():
                if aug_name == "pipeline" or not isinstance(aug_cfg, dict):
                    continue
                merged_cfgs.setdefault(aug_name, {}).update(aug_cfg)

    for k, v in merged_pipeline.items():  # inline dataset values win
        if dataset.get(k) is None:
            dataset[k] = v
    for aug_name, cfg in inline_cfgs.items():
        merged_cfgs.setdefault(aug_name, {}).update(cfg)
    dataset["aug_configs"] = merged_cfgs
