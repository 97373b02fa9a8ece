from .gan import AdversarialLoss, build_adversarial, gan_loss
from .generator_loss import GeneratorLoss, LossEntry, build_loss_list

__all__ = ["AdversarialLoss", "build_adversarial", "gan_loss",
           "GeneratorLoss", "LossEntry", "build_loss_list"]
