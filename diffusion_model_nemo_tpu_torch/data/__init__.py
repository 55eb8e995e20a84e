from .hf_vision_data import DataLoader, SyntheticVisionDataset, build_dataloader, preprocess_batch

__all__ = ["DataLoader", "SyntheticVisionDataset", "build_dataloader", "preprocess_batch"]
