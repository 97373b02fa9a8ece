"""Data layer: host-side datasets, a loader that hands batches to the card
through pinned memory, and the on-device degradation pipeline."""

from .common import img2tensor, modcrop, read_img, save_img, tensor2img
from .datasets import AlignedDataset, SingleDataset, SyntheticDataset, create_dataset
from .loader import DataLoader, create_dataloader, device_prefetch
from .pipeline import BatchDegrader, get_unpaired_params

__all__ = ["read_img", "img2tensor", "tensor2img", "save_img", "modcrop",
           "AlignedDataset", "SingleDataset", "SyntheticDataset",
           "create_dataset", "DataLoader", "create_dataloader",
           "device_prefetch", "BatchDegrader", "get_unpaired_params"]
