from .hf_vision_data import (
    DataLoader, SyntheticAudioDataset, SyntheticVisionDataset, build_dataloader, preprocess_batch,
)

__all__ = ["DataLoader", "SyntheticAudioDataset", "SyntheticVisionDataset", "build_dataloader", "preprocess_batch"]
