"""FID (and KID, IS) between dataset images and a DDPM archive's samples
with the port (counterpart of ``examples/ddpm/compute_fid.py``).

    python -m diffusion_model_nemo_tpu_torch.cli.compute_fid model_path=DDPM.dmn \\
        dataset_name=synthetic num_samples=1024 batch_size=64 compute_kid=true compute_is=true
    ... feature_weights_path=pt_inception.pth   # standard Inception FID
    ... feature_extractor=pixels                  # the weight-free moments

The samples come from the archive's DDPM (EMA weights by default) through
the captured DDIM chain (``use_ddim_sampler``, ``ddim_timesteps``), one
generator seeded from ``seed``; the real images from ``dataset_name``
(``synthetic``, or ``file`` with ``dataset_path``; a Hugging Face name raises:
it needs a download). Without ``feature_weights_path`` the InceptionV3
extractor runs seeded random weights, and every line says so. Prints the
JAX script's ``FID: ... [label]``, ``KID: ...`` and ``IS: ...`` lines.
``device=cpu`` runs on the CPU.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..data.hf_vision_data import build_dataloader
from ..metrics import FIDScorer, default_feature_fn, inception_feature_fn, inception_score
from ..models import DDPM
from ..utils.image import to_uint8
from .common import hydra_runner

log = logging.getLogger(__name__)


@dataclass
class FIDConfig:
    model_path: str = "DDPM.dmn"
    dataset_name: Optional[str] = None
    dataset_path: Optional[str] = None  # for dataset_name=file (offline data)
    dataset_split: str = "test"
    num_samples: int = 1024
    batch_size: int = 64
    use_ddim_sampler: bool = True
    ddim_timesteps: int = 50
    seed: int = 0
    use_ema: bool = True
    # Standard Inception FID: a local torchvision / pytorch-fid InceptionV3
    # checkpoint (.pth/.pt/.bin/.npz). Unset: seeded RANDOM weights, a
    # relative metric only, labelled so.
    feature_weights_path: Optional[str] = None
    feature_extractor: str = "inception"  # or 'pixels' (the weight-free moments)
    compute_kid: bool = False
    kid_subset_size: Optional[int] = None  # default min(N, M, 1000)
    compute_is: bool = False
    is_splits: int = 10
    device: str = "cuda"


@hydra_runner(schema=FIDConfig)
def main(cfg):
    """Returns {"fid", "label", "kid" / "is" as (mean, std) when asked, and
    the seconds spent sampling, extracting features and in the host-side
    scores: "sample_s", "features_s", "frechet_s", "kid_s", "is_s"}."""
    cfg = FIDConfig(**cfg)
    model = DDPM.restore_from(cfg.model_path, use_ema=cfg.use_ema, device=cfg.device)
    if cfg.use_ddim_sampler:
        ddim = "diffusion_model_nemo.modules.GeneralizedGaussianDiffusion"
        model.change_sampler(dict(model.cfg.sampler, _target_=ddim, eta=0.0, ddim_timesteps=cfg.ddim_timesteps))

    name = cfg.dataset_name or (model.cfg.get("train_ds") or {}).get("name")
    ds_cfg = {"name": name, "split": cfg.dataset_split, "batch_size": cfg.batch_size}
    if cfg.dataset_path:
        ds_cfg["path"] = cfg.dataset_path
    dl = build_dataloader(ds_cfg, mode="test")

    if cfg.compute_is and cfg.feature_extractor != "inception":
        raise ValueError("compute_is requires feature_extractor=inception")
    if cfg.feature_extractor == "inception":
        feature_fn = inception_feature_fn(weights_path=cfg.feature_weights_path, batch_size=cfg.batch_size,
                                          with_logits=cfg.compute_is, device=cfg.device)
        label = ("InceptionV3-pool3 (standard FID)" if not feature_fn.using_random_weights
                 else "InceptionV3-pool3 with RANDOM weights (relative metric only)")
    else:
        feature_fn, label = None, "pixel moments (relative metric only)"
    log.info(f"FID feature extractor: {label}")

    seconds = {"sample_s": 0.0, "features_s": 0.0, "frechet_s": 0.0, "kid_s": 0.0, "is_s": 0.0}

    def extract(images):
        """(features, probabilities or None) whatever the extractor."""
        t0 = time.perf_counter()
        if feature_fn is None:
            out = default_feature_fn(images), None
        else:
            out = feature_fn(images)
            out = out if cfg.compute_is else (out, None)
        seconds["features_s"] += time.perf_counter() - t0
        return out

    scorer = FIDScorer(feature_fn=None)
    seen = 0
    for batch in dl:
        scorer.update_real_features(extract(batch["image"])[0])
        seen += batch["image"].shape[0]
        if seen >= cfg.num_samples:
            break

    generator = torch.Generator(device=model.device).manual_seed(cfg.seed)
    generated, gen_probs = 0, []
    while generated < cfg.num_samples:
        t0 = time.perf_counter()
        imgs = model.sample(batch_size=cfg.batch_size, image_size=int(model.image_size), generator=generator)
        imgs = to_uint8(imgs.float().cpu().numpy())
        seconds["sample_s"] += time.perf_counter() - t0
        feats, probs = extract(imgs)
        scorer.update_generated_features(feats)
        if probs is not None:
            gen_probs.append(probs)
        generated += cfg.batch_size
        log.info(f"generated {generated}/{cfg.num_samples}")

    t0 = time.perf_counter()
    fid = scorer.compute()
    seconds["frechet_s"] = time.perf_counter() - t0
    result = {"fid": fid, "label": label}
    log.info(f"FID [{label}] ({generated} generated vs {seen} real): {fid:.4f}")
    print(f"FID: {fid:.4f} [{label}]")
    if cfg.compute_kid:
        t0 = time.perf_counter()
        kid_mean, kid_std = scorer.compute_kid(subset_size=cfg.kid_subset_size)
        seconds["kid_s"] = time.perf_counter() - t0
        result["kid"] = (kid_mean, kid_std)
        print(f"KID: {kid_mean:.6f} +/- {kid_std:.6f} [{label}]")
    if cfg.compute_is:
        t0 = time.perf_counter()
        is_mean, is_std = inception_score(np.concatenate(gen_probs), splits=cfg.is_splits)
        seconds["is_s"] = time.perf_counter() - t0
        result["is"] = (is_mean, is_std)
        print(f"IS: {is_mean:.4f} +/- {is_std:.4f} [{label}]")
    return {**result, **seconds}


if __name__ == "__main__":
    main()
