"""The host-side helpers of ``chip_smoke.py``'s phase 24 (several GPUs
on the one card), on the CPU: the gradient reading of its two-rank part,
the CLI options it writes, and the command a rank runs."""

import torch

import chip_smoke
from trainner_tpu_torch.train.sr_trainer import create_trainer

torch.set_num_threads(2)


def _tiny():
    opt = {"is_train": True, "scale": 2, "use_amp": False,
           "network_G": {"type": "rrdb_net", "nf": 8, "nb": 1, "gc": 4,
                         "upscale": 2, "gaussian_noise": False},
           "network_D": {"type": "discriminator_vgg", "size": 16,
                         "base_nf": 8},
           "train": {"lr_G": 1e-3, "lr_D": 1e-3, "pixel_criterion": "l1",
                     "pixel_weight": 1.0, "gan_type": "vanilla",
                     "gan_weight": 5e-3, "lr_scheme": "MultiStepLR",
                     "lr_steps": [100]}}
    tr = create_trainer(opt, device="cpu", graphs=False)
    st = tr.init_state(0)
    gen = torch.Generator().manual_seed(0)
    st, _ = tr.train_step(st, {"LR": torch.rand(4, 8, 8, 3, generator=gen),
                               "HR": torch.rand(4, 16, 16, 3,
                                                generator=gen)})
    return st


def test_grad_errors_read_each_tensor_against_its_size():
    """Equal gradients read 0; a change of 1e-3 of a weight's largest
    magnitude reads 1e-3; D's biases in front of a batch norm and the
    dense layers' are read against D's largest gradient."""
    st = _tiny()
    for which, net in (("g", st.g.net), ("d", st.d.net)):
        got = {k: p.grad.clone() for k, p in net.named_parameters()}
        assert max(chip_smoke._grad_errors(got, net, which).values()) == 0
    names = dict(st.d.net.named_parameters())
    noise = [k for k in names if k.endswith("bias") and (
        k.startswith("linear") or k.replace("bias", "norm.weight")
        in names)]
    assert "conv0_1.bias" in noise and "conv0_0.bias" not in noise
    got = {k: p.grad.clone() for k, p in names.items()}
    top = max(float(p.grad.abs().max()) for p in names.values())
    w = got["conv0_0.weight"]
    w += 1e-3 * float(w.abs().max())
    got[noise[0]] = got[noise[0]] + 2e-3 * top
    errs = chip_smoke._grad_errors(got, st.d.net, "d")
    assert abs(errs["d.conv0_0.weight"] - 1e-3) < 1e-6
    assert abs(errs[f"d.{noise[0]}"] - 2e-3) < 1e-6


def test_parallel_cli_options_and_resume_edit(tmp_path):
    """The phase's CLI options carry ``parallel: {data: 1}`` beside the
    train set on the corpus; its resume's edit drops it, so the resume
    runs with no group."""
    import numpy as np

    from trainner_tpu_torch.data.common import save_img

    corpus = tmp_path / "corpus"
    corpus.mkdir()
    rng = np.random.default_rng(0)
    for i in range(2):
        save_img(rng.integers(0, 256, (32, 32, 3), np.uint8),
                 str(corpus / f"{i:04d}.png"))
    path = chip_smoke._cli_options(
        str(tmp_path), str(corpus), chip_smoke.TRAIN_YML, "cli_parallel",
        edit=lambda o: o.update(parallel={"data": 1}), niter=6)
    import json

    with open(path) as f:
        opt = json.load(f)
    assert opt["parallel"] == {"data": 1}
    assert opt["datasets"]["train"]["dataroot_HR"] == str(corpus)
    assert opt["train"]["niter"] == 6
    opt.pop("parallel", None)
    assert "parallel" not in opt


def test_phase_24_is_among_the_later_phases():
    """``--only 24`` reaches phase 24, and a whole run lists it."""
    import inspect

    src = inspect.getsource(chip_smoke._later_phases)
    assert "24: phase_parallel" in src
    assert "(18, 19, 20, 21, 22, 23, 24)" in inspect.getsource(
        chip_smoke.main)
    assert chip_smoke.PAR_SPLIT * 2 == chip_smoke.TRAIN_SHAPE[0]
    assert chip_smoke.BAND_PX // chip_smoke.N_BANDS >= chip_smoke.BAND_HALO


def test_planted_faults_patch_the_step_and_are_put_back():
    """Each of phase 24 (b)'s planted faults replaces one function of the
    step while its context is open and puts it back after; the unaveraged
    D gradient still averages every other net's."""
    from trainner_tpu_torch.losses import gan
    from trainner_tpu_torch.ops import blocks
    from trainner_tpu_torch.train import sr_trainer

    st = _tiny()
    d_params = list(st.d.net.parameters())
    g_params = list(st.g.net.parameters())
    places = {chip_smoke.PAR_FAULTS[0]: (blocks, "batch_mean"),
              chip_smoke.PAR_FAULTS[1]: (gan, "batch_mean"),
              chip_smoke.PAR_FAULTS[2]: (sr_trainer, "average_grads")}
    assert set(places) == set(chip_smoke.PAR_FAULTS)
    averaged = []
    kept = sr_trainer.average_grads
    sr_trainer.average_grads = averaged.append
    try:
        for fault, (mod, attr) in places.items():
            before = getattr(mod, attr)
            with chip_smoke._par_fault(fault, d_params):
                assert getattr(mod, attr) is not before
                if attr == "batch_mean":
                    x = torch.rand(3)
                    assert getattr(mod, attr)(x) is x
                else:
                    sr_trainer.average_grads(d_params)
                    sr_trainer.average_grads(g_params)
            assert getattr(mod, attr) is before
    finally:
        sr_trainer.average_grads = kept
    assert averaged == [g_params]


def test_the_two_rank_reading_holds_each_tensor_to_its_limit():
    """``_par_reading``: equal gradients and logs read 0 and nothing
    over; a weight moved by 1e-2 of its size is over 3e-3 unless the
    reorders moved it by more than a third of that; a log moved by 1e-2
    reads 1e-2."""
    st = _tiny()
    run = {w: {k: p.grad.clone() for k, p in
               getattr(st, w).net.named_parameters()} for w in ("g", "d")}
    logs = {"l_g_pix": torch.tensor(0.5)}
    run["logs"] = {"l_g_pix": 0.5}
    names = [f"{w}.{k}" for w in ("g", "d") for k in run[w]]
    spread = dict.fromkeys(names, 0.0)
    worst, over, ratio, log_err = chip_smoke._par_reading(
        run, st, logs, spread)
    assert not over and ratio == 0 and log_err == 0
    w = run["g"]["conv_first.weight"]
    w += 1e-2 * float(w.abs().max())
    run["logs"]["l_g_pix"] = 0.505
    worst, over, ratio, log_err = chip_smoke._par_reading(
        run, st, logs, spread)
    assert list(over) == ["g.conv_first.weight"]
    assert abs(ratio - 1e-2 / 3e-3) < 1e-3 and abs(log_err - 1e-2) < 1e-9
    spread["g.conv_first.weight"] = 4e-3
    assert not chip_smoke._par_reading(run, st, logs, spread)[1]
