"""Inference and metrics CLI of the port: counterpart of the JAX package's
``test.py`` for ``model: sr``, ``model: ppon`` (the output of
``ppon_phase``, 3 by default), ``sftgan`` (with the batch's ``seg`` maps
where a ``seg`` dataset gives them, ``test.py:116-118``; ``sftgan_acd``
with uniform maps, as the JAX CLI serves it), ``pix2pix`` (G) and
``cyclegan`` (G_A; ``pretrain_model_G`` a ``{tag}_G_A.ckpt``, or a tree of
both Gs) from a ``single`` dataset's ``LR``, and the video models (``vsr``,
``vsrgan``, ``evsrgan``, ``video``: the sliding windows of a ``video``
dataset, the centre frame served and scored against the centre of the HR
clip, ``test.py:157-161``) and ``srflow`` (for each heat of
``val.heats``, ``val.n_sample`` samples saved as
``{name}_h{heat:.2f}_{k}.png``, and the sample at the first heat saved
and scored, ``test.py:99-110``), ``dvd`` (a ``dvd`` dataset's interlaced
``in``: the top frame saved as the result and the bottom one as
``{i}_bottom.png``, ``test.py:111-115``), ``wbc`` (G and its guided
filter, from a ``single`` dataset) and ``pbr`` (G on the primary map of
a ``pbr`` dataset, scored against its HR), with its x8 self-ensemble
(``self_ensemble`` / ``x8``), band-parallel (``spatial_shards`` bands with
``spatial_halo`` rows of halo, 32 by default: ``eval_step_spatial``),
tiled (``chop_forward`` / ``chop``) and plain ``eval_step`` branches,
taken in that order as the JAX CLI takes them, and
its CEM post-processing (``test.py:129-150``): with ``use_cem`` and
``cem_config.out_orig`` the output without CEM is computed too, and
``out_filter`` (a guided filter of the CEM correction, ``out_filter_ks``)
and ``out_keepY`` (the luma without CEM, the chroma with it) combine the
two.

``which`` (``g``, ``ema``, ``swa`` or ``auto``, the default) is the copy
of the weights ``eval_step`` serves: the loaded ``pretrain_model_G`` (a
``{tag}_swaG.ckpt`` with its batch-norm statistics too) goes into that
copy of the state; ``auto`` serves EMA weights where the state keeps them,
else G, as the JAX package's ``eval_step`` does.

Runs G over every configured test dataset, writes one PNG per image and
logs PSNR and SSIM (RGB and Y) per image and per dataset, with the same
options keys and log lines as the JAX CLI. On the card ``eval_step`` replays
one CUDA graph per input shape.

Usage: python -m trainner_tpu_torch.test -opt options.json
"""

from __future__ import annotations

import argparse
import os
from typing import Dict, List, Optional, Union

import torch

def parse_options(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("-opt", type=str, required=True)
    args = parser.parse_args(argv)
    from .options import parse

    return parse(args.opt, is_train=False)


def _check_ported(opt) -> None:
    model = (opt.get("model") or "sr").lower()
    if model == "ppon" and opt.get("use_cem") and \
            (opt.get("cem_config") or {}).get("out_orig"):
        raise NotImplementedError(
            "CEM's out_orig with model [ppon]: PPON's eval_step takes no "
            "apply_cem, so the JAX CLI raises a TypeError there "
            "(ROADMAP C 20)")


def _band_devices(opt, device: torch.device):
    """The devices of ``spatial_shards`` bands (``test.py:63-72``): on the
    card, cards 0 .. n-1 where at least n are visible (else None: the
    image is served whole, as the JAX CLI serves it with fewer devices);
    on the CPU, n bands one after another. None without
    ``spatial_shards`` above 1."""
    n = int(opt.get("spatial_shards") or 0)
    if n <= 1:
        return None
    if device.type == "cpu":
        return [device] * n
    if torch.cuda.device_count() < n:
        return None
    return [torch.device("cuda", i) for i in range(n)]


def _cem_post(sr_orig: torch.Tensor, sr: torch.Tensor,
              cem_cfg: dict) -> torch.Tensor:
    """The CEM output ``sr`` combined with the output without CEM
    ``sr_orig`` as ``cem_config`` says: ``out_filter`` adds a guided
    filter of the CEM correction (window ``out_filter_ks``) to
    ``sr_orig``; ``out_keepY`` keeps ``sr_orig``'s luma with the chroma of
    what it has so far."""
    from .ops.colors import rgb_to_ycbcr, ycbcr_to_rgb
    from .ops.filters import guided_filter

    if cem_cfg.get("out_filter"):
        ks = int(cem_cfg.get("out_filter_ks", 7))
        sr = sr_orig + guided_filter(sr, sr - sr_orig, radius=(ks - 1) // 2)
    if cem_cfg.get("out_keepY"):
        y_orig, y_cem = rgb_to_ycbcr(sr_orig), rgb_to_ycbcr(sr)
        sr = ycbcr_to_rgb(torch.cat([y_orig[..., :1], y_cem[..., 1:]],
                                    dim=-1))
    return sr


def main(argv=None, device: Union[str, torch.device, None] = None
         ) -> Dict[str, List[Dict]]:
    """Runs the CLI. ``device`` defaults to ``cuda``. Returns, by dataset
    name, the averages that the last log line of each dataset reports."""
    opt = parse_options(argv)
    _check_ported(opt)

    from .data import create_dataloader, create_dataset
    from .data.common import save_img, tensor2img
    from .train.sr_trainer import create_trainer
    from .train.state import init_ema, init_swa
    from .utils.logging_utils import get_root_logger, mkdirs
    from .utils.metrics import MetricsDict

    mkdirs([opt["path"]["results_root"], opt["path"]["log"]])
    logger = get_root_logger("base", opt["path"]["log"], "test")

    trainer = create_trainer(opt, device=device)
    if trainer.dtype == torch.float32:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    logger.info(f"Inference on {trainer.device} in {trainer.dtype}; "
                f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
                f"cuda.matmul.allow_tf32="
                f"{torch.backends.cuda.matmul.allow_tf32}")

    pin = trainer.device.type == "cuda"
    test_loaders = []
    for phase_key, dataset_opt in (opt.get("datasets") or {}).items():
        ds = create_dataset(dataset_opt)
        test_loaders.append((dataset_opt.get("name") or phase_key,
                             create_dataloader(ds, dataset_opt,
                                               pin_memory=pin)))

    state = None
    scale = int(opt.get("scale") or 1)
    ensemble_x8 = bool(opt.get("self_ensemble") or opt.get("x8"))
    chop = bool(opt.get("chop_forward") or opt.get("chop"))
    model = (opt.get("model") or "sr").lower()
    which = str(opt.get("which") or "auto")
    # SRFlow's heats x n_sample draws per image (test.py:73-75)
    heats = (opt.get("val") or {}).get("heats") or [0.0]
    n_sample = int((opt.get("val") or {}).get("n_sample", 1) or 1)
    if which not in ("g", "ema", "swa", "auto"):
        raise ValueError(f"which [{which}]: 'g', 'ema', 'swa' or 'auto'")
    # band-parallel serving of big images (parallel/spatial.py)
    bands = _band_devices(opt, trainer.device)
    halo = int(opt.get("spatial_halo") or 32)
    if bands is not None:
        logger.info(f"Serving in {len(bands)} bands of the height, halo "
                    f"{halo}, on {', '.join(str(d) for d in bands)}")
    znorm = False
    averages: Dict[str, List[Dict]] = {}
    for name, loader in test_loaders:
        logger.info(f"Testing [{name}]...")
        res_dir = os.path.join(opt["path"]["results_root"], name)
        os.makedirs(res_dir, exist_ok=True)
        lpips_w = (opt.get("path") or {}).get("lpips_weights")
        metrics = MetricsDict(opt.get("metrics") or "psnr,ssim",
                              lpips_weights=lpips_w, device=trainer.device)
        metrics_y = MetricsDict(opt.get("metrics") or "psnr,ssim",
                                lpips_weights=lpips_w, device=trainer.device)
        n_img = 0
        for i, batch in enumerate(loader):
            if state is None:
                g_path: Optional[str] = opt["path"].get("pretrain_model_G")
                state = trainer.init_state(0, g_path)
                if g_path:
                    logger.info(f"Loaded G from {g_path}")
                else:
                    logger.warning("No pretrain_model_G given — running "
                                   "random-init weights.")
                if which == "swa":
                    # the loaded weights (a {tag}_swaG.ckpt) as the
                    # state's SWA copy, which eval_step's "swa" serves
                    init_swa(state)
                elif which == "ema":
                    init_ema(state)
            if model == "srflow":
                stem = os.path.splitext(os.path.basename(
                    batch.get("LR_path", [str(i)])[0]))[0]
                # eval_step draws from seed 0 on every call, so the first
                # sample at heats[0] is the one the JAX CLI scores
                sr = None
                for heat in heats:
                    for k in range(n_sample):
                        s = trainer.eval_step(state, batch["LR"], heat=heat)
                        save_img(tensor2img(s[0], znorm), os.path.join(
                            res_dir, f"{stem}_h{heat:.2f}_{k}.png"))
                        sr = s if sr is None else sr
            elif model == "dvd":
                # the top frame is the result; the bottom one is saved
                # beside it by the batch's index (test.py:111-115)
                sr, bottom = trainer.eval_step_both(state, batch["in"])
                save_img(tensor2img(bottom[0], znorm),
                         os.path.join(res_dir, f"{i}_bottom.png"))
            elif model == "sftgan" and "seg" in batch:
                sr = trainer.eval_step(state, batch["LR"], batch["seg"])
            elif model in ("sftgan", "sftgan_acd") and not (
                    ensemble_x8 or chop):
                sr = trainer.eval_step(state, batch["LR"], which=which)
            elif ensemble_x8:
                sr = trainer.eval_step_x8(state, batch["LR"], which)
            elif bands is not None:
                sr = trainer.eval_step_spatial(state, batch["LR"], bands,
                                               halo=halo, which=which)
            elif chop:
                sr = trainer.eval_step_chop(state, batch["LR"], which=which)
            else:
                sr = trainer.eval_step(state, batch["LR"], which)
            cem_cfg = opt.get("cem_config") or {}
            if opt.get("use_cem") and cem_cfg.get("out_orig"):
                sr = _cem_post(trainer.eval_step(state, batch["LR"],
                                                 apply_cem=False),
                               sr, cem_cfg)
            sr_img = tensor2img(sr[0], znorm)
            img_name = os.path.splitext(os.path.basename(
                batch.get("LR_path", [str(i)])[0]))[0]
            save_img(sr_img, os.path.join(res_dir, img_name + ".png"))
            n_img += 1
            if batch.get("HR") is not None:
                gt = batch["HR"]
                if gt.dim() == 5:  # a clip: score its centre frame
                    gt = gt[:, gt.shape[1] // 2]
                gt_img = tensor2img(gt[0], znorm)
                r = metrics.calculate_metrics(sr_img, gt_img,
                                              crop_size=scale)
                ry = metrics_y.calculate_metrics(sr_img, gt_img,
                                                 crop_size=scale,
                                                 only_y=True)
                msg = " ".join(f"{k}: {v:.6g}" for k, v in r.items())
                msgy = " ".join(f"{k}_Y: {v:.6g}" for k, v in ry.items())
                logger.info(f"{img_name:20s} | {msg} | {msgy}")
        avg = metrics.get_averages()
        avgy = metrics_y.get_averages()
        averages[name] = avg + [{"name": m["name"] + "_Y",
                                 "average": m["average"]} for m in avgy]
        if avg:
            msg = " ".join(f"{m['name']}: {m['average']:.6g}" for m in avg)
            msgy = " ".join(f"{m['name']}_Y: {m['average']:.6g}"
                            for m in avgy)
            logger.info(f"[{name}] average ({n_img} images) | {msg} | "
                        f"{msgy}")
        else:
            logger.info(f"[{name}] saved {n_img} images (no GT metrics)")
    return averages


if __name__ == "__main__":
    main()
