from .sr_trainer import SRTrainer, create_trainer

__all__ = ["SRTrainer", "create_trainer"]
