"""The augmentations in the port's training step against the JAX
package's on the CPU (the harness of ``test_torch_trainer_options.py``:
one carried state, the port on JAX's draws): three steps with each batch
augmentation alone in the mixture (chosen at every step; cutout's mask on
the loss's inputs and the G stage's D inputs, cutblur on the LR pair
brought to HR's size), with the yml's five, and with each DiffAugment
policy on D's inputs in both stages (a step without a G update between,
and a virtual batch, whose G stage draws for its microbatch size).
"""

import pytest
import torch

from test_torch_trainer_options import options, run

torch.set_num_threads(2)


@pytest.mark.parametrize("aug", ["blend", "rgb", "mixup", "cutmix",
                                 "cutmixup", "cutblur", "cutout"])
def test_each_batch_augmentation_steps_match_jax(aug):
    """``mixup`` with ``mixopts: [aug]`` at probability 1e6 against
    ``none``'s 1; cutout at a drop rate of 0.2 so that its mask shows."""
    train = {"mixup": True, "mixopts": [aug], "mixprob": [1e6]}
    if aug == "cutout":
        train["mixalpha"] = [0.2]
    run(options(**train), 3)


def test_the_yml_mixture_steps_match_jax():
    """``train_sr.yml``'s ``mixopts`` (blend, rgb, mixup, cutmix,
    cutmixup) with ``D_update_ratio: 2``, five steps."""
    run(options(mixup=True, D_update_ratio=2), 5, seed=3)


@pytest.mark.parametrize("policy,extra", [
    ("color,translation,cutout", {"D_update_ratio": 2}),
    ("flip,rotate", {}),
    ("zoom_in,zoom_out", {"virtual_batch_size": 2}),
    ("offset,offset_h,offset_v", {}),
])
def test_diffaug_steps_match_jax(policy, extra):
    """Each policy on the fake and the real batch with one draw, in the G
    stage and the D stage."""
    run(options(diffaug=True, dapolicy=policy, **extra), 3)
