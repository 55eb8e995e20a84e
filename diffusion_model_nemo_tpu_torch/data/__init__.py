from .hf_vision_data import (
    DataLoader, SyntheticAudioDataset, SyntheticVisionDataset, build_dataloader, preprocess_batch,
)
from .prefetch import ThreadedPrefetcher

__all__ = ["DataLoader", "SyntheticAudioDataset", "SyntheticVisionDataset", "ThreadedPrefetcher", "build_dataloader",
           "preprocess_batch"]
