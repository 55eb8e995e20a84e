from .augment import AUGMENT_DIM, apply_augment, augment_pipe, sample_augment_labels
from .hf_vision_data import (
    DataLoader, FileVisionDataset, SyntheticAudioDataset, SyntheticVisionDataset, build_dataloader, preprocess_batch,
    read_image_rgb, to_uint8_nhwc,
)
from .prefetch import ThreadedPrefetcher

__all__ = ["AUGMENT_DIM", "apply_augment", "augment_pipe", "sample_augment_labels", "DataLoader", "FileVisionDataset", "SyntheticAudioDataset", "SyntheticVisionDataset", "ThreadedPrefetcher", "build_dataloader",
           "preprocess_batch", "read_image_rgb", "to_uint8_nhwc"]
