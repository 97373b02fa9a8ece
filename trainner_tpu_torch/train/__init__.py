from .cli import main
from .producer import batches, make_otf_degradation
from .sr_trainer import SRTrainer, create_trainer

__all__ = ["SRTrainer", "create_trainer", "make_otf_degradation", "batches",
           "main"]
