import logging

from ..modules.parts import not_ported
from .abstract_diffusion_model import AbstractDiffusionModel, resolve_archive_path
from .autoencoder_kl import AutoencoderKLModel
from .conditional_ddpm import ConditionalDDPM
from .conditional_edm import ConditionalEDM
from .ddpm import DDPM
from .edm import EDM
from .improved_ddpm import ImprovedDDPM
from .latent_diffusion import LatentDiffusion
from .rectified_flow import RectifiedFlow
from .score_sde import ScoreSDE
from .sr3 import SR3
from .text_conditional_ddpm import TextConditionalDDPM
from .wavegrad_ddpm import WavegradDDPM
from .wavegrad_vocoder import WavegradVocoderModel

__all__ = ["AbstractDiffusionModel", "AutoencoderKLModel", "ConditionalDDPM", "ConditionalEDM", "DDPM", "EDM",
           "ImprovedDDPM", "LatentDiffusion", "RectifiedFlow", "ScoreSDE", "SR3", "TextConditionalDDPM", "WavegradDDPM",
           "WavegradVocoderModel", "restore_model_from_archive"]

_MODEL_CLASSES = {"DDPM": DDPM, "ImprovedDDPM": ImprovedDDPM, "ConditionalDDPM": ConditionalDDPM,
                  "ScoreSDE": ScoreSDE, "WavegradDDPM": WavegradDDPM, "WavegradVocoderModel": WavegradVocoderModel,
                  "EDM": EDM, "ConditionalEDM": ConditionalEDM, "SR3": SR3,
                  "RectifiedFlow": RectifiedFlow, "AutoencoderKLModel": AutoencoderKLModel,
                  "LatentDiffusion": LatentDiffusion, "TextConditionalDDPM": TextConditionalDDPM}


def restore_model_from_archive(path: str, use_ema: bool = False, device="cuda"):
    """Restore an archive (or a local-hub model name) without knowing its
    family: the ``model_class`` that ``save_to`` records in ``extra.yaml``
    picks the class; an archive that records none restores as :class:`DDPM`
    (as in the JAX package), one that names a family not ported yet raises."""
    from ..training.checkpoints import load_archive

    path = resolve_archive_path(path)
    _, _, _, extra = load_archive(path)
    name = (extra or {}).get("model_class")
    if name is None:
        logging.getLogger(__name__).info(f"Archive {path} records no model_class; restoring as DDPM")
        name = "DDPM"
    if name not in _MODEL_CLASSES:
        raise not_ported("restore_model_from_archive", f"model_class={name!r}", "model families")
    return _MODEL_CLASSES[name].restore_from(path, use_ema=use_ema, device=device)
