from .augment import AUGMENT_DIM, apply_augment, augment_pipe, sample_augment_labels
from .hf_vision_data import (
    DataLoader, SyntheticAudioDataset, SyntheticVisionDataset, build_dataloader, preprocess_batch,
)
from .prefetch import ThreadedPrefetcher

__all__ = ["AUGMENT_DIM", "apply_augment", "augment_pipe", "sample_augment_labels", "DataLoader", "SyntheticAudioDataset", "SyntheticVisionDataset", "ThreadedPrefetcher", "build_dataloader",
           "preprocess_batch"]
