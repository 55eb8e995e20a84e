"""Sample-quality metrics: FID statistics, IS and KID on the host (numpy),
PSNR and SSIM on tensors, and the InceptionV3 pool3 extractor of standard
FID (``inception.py``)."""

from .fid import FIDScorer, compute_statistics, default_feature_fn, frechet_distance
from .image_quality import psnr, ssim
from .inception import INCEPTION_FEATURE_DIM, InceptionV3, inception_feature_fn, load_inception_state_dict
from .scores import inception_score, kernel_inception_distance, polynomial_kernel

__all__ = ["FIDScorer", "INCEPTION_FEATURE_DIM", "InceptionV3", "compute_statistics", "default_feature_fn",
           "frechet_distance", "inception_feature_fn", "inception_score", "kernel_inception_distance",
           "load_inception_state_dict", "polynomial_kernel", "psnr", "ssim"]
