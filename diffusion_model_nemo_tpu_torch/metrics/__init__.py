"""Sample-quality metrics: FID statistics, IS and KID on the host (numpy),
PSNR and SSIM on tensors. The InceptionV3 extractor comes with a later
slice of the port."""

from .fid import FIDScorer, compute_statistics, default_feature_fn, frechet_distance
from .image_quality import psnr, ssim
from .scores import inception_score, kernel_inception_distance, polynomial_kernel

__all__ = ["FIDScorer", "compute_statistics", "default_feature_fn", "frechet_distance", "inception_score",
           "kernel_inception_distance", "polynomial_kernel", "psnr", "ssim"]
