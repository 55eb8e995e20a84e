"""Text-conditional DDPM: sequence conditioning through the DiT's
cross-attention, with prompts, negative prompts and classifier-free
guidance.

Counterpart of ``diffusion_model_nemo_tpu/models/text_conditional_ddpm.py``.
The batch carries byte-tokenized captions (``tokens`` [B, max_text_len],
``utils/text.py``); the backbone (a ``DiT`` with ``context_dim`` > 0)
embeds them and cross-attends from every image token. In training each
caption becomes the all-PAD null context with probability
``cond_drop_prob`` (the per-sample drop vector ``cond_drop`` [B], drawn
with the flip, t and noise in ``draw_training_inputs`` and injected, as
``ConditionalDDPM``'s label mask is), so one network models both.
``sample(text=...)`` prompts the chain (one string for the batch, or one a
row; None is the null context); ``guidance_scale = w`` guides with one
network call on the 2B batch ``[x, x]`` with contexts ``[prompt, anchor]``
a step, ε = ε_a + w·(ε_c − ε_a) (the ε half only under a learned
variance), where the anchor is the null context, or ``negative_text``'s
tokens; ``context=`` takes a float [B, L, context_dim] (or [L,
context_dim]) sequence from an outside encoder instead of the tokenizer,
whose guided anchor is all zeros. The prompt tokens, the anchor and the
guidance scale (a float32 0-d tensor) reach the network as a
``Conditioned`` model function, so a captured chain holds them as static
buffers refilled before every chain: one unguided graph and one guided
graph serve every prompt and every scale (the JAX package compiles one
program for each scale). ``interpolate(text=...)`` runs DDPM's with the
prompt bound.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Union

import numpy as np
import torch

from ..config.registry import register_target
from ..data.hf_vision_data import preprocess_batch
from ..modules.gaussian_diffusion import Conditioned
from ..utils.text import ByteTokenizer
from .ddpm import DDPM

__all__ = ["TextConditionalDDPM"]

Prompts = Union[None, str, Sequence[str]]


@register_target("diffusion_model_nemo.models.TextConditionalDDPM",
                 "diffusion_model_nemo_tpu.models.TextConditionalDDPM")
class TextConditionalDDPM(DDPM):
    def __init__(self, cfg, device: Union[str, torch.device] = "cuda", seed: int = 0):
        super().__init__(cfg, device=device, seed=seed)
        net = self.cfg.diffusion_model
        self.context_dim = int(net.get("context_dim", 0) or 0)
        if not self.context_dim:
            raise ValueError("TextConditionalDDPM needs diffusion_model.context_dim > 0 "
                             "(a cross-attention backbone, e.g. the DiT)")
        self.max_text_len = int(self.cfg.get("max_text_len", 32))
        self.cond_drop_prob = float(self.cfg.get("cond_drop_prob", 0.1))
        self.tokenizer = ByteTokenizer(self.max_text_len)
        if int(net.get("context_vocab", 0) or 0) not in (0, self.tokenizer.vocab_size):
            raise ValueError(f"diffusion_model.context_vocab must be {self.tokenizer.vocab_size} (byte tokenizer) "
                             f"or 0 (external float contexts); got {net.get('context_vocab')}")

    # ---- plumbing ------------------------------------------------------------
    def _tokens_array(self, batch_size: int, text: Prompts) -> torch.Tensor:
        """[B, max_text_len] int32 on the device: None is the null context,
        one string is broadcast over the batch, a sequence gives a row
        each."""
        if text is None:
            tokens = self.tokenizer.null(batch_size)
        elif isinstance(text, str):
            tokens = np.tile(self.tokenizer.encode(text)[None], (batch_size, 1))
        else:
            if len(text) != batch_size:
                raise ValueError(f"{len(text)} prompts for batch_size={batch_size}")
            tokens = self.tokenizer.encode_batch(list(text))
        return torch.from_numpy(tokens).to(self.device)

    def get_model_fn(self, batch: Optional[Dict] = None, training: bool = False, dropout_masks=None,
                     cond_drop: Optional[torch.Tensor] = None):
        """The network with ``batch``'s captions bound (none: the null
        context); in training the rows where ``cond_drop`` is true become
        the all-PAD null context, and the dropout masks are bound."""
        fn = super().get_model_fn(training=training, dropout_masks=dropout_masks)
        if batch is None or "tokens" not in batch:
            return fn
        tokens = torch.as_tensor(batch["tokens"]).to(device=self.device, dtype=torch.int32)
        if cond_drop is not None:
            tokens = torch.where(cond_drop[:, None], 0, tokens)
        return Conditioned(fn, {"context": tokens})

    def draw_training_inputs(self, shape, generator: Optional[torch.Generator]) -> Dict[str, torch.Tensor]:
        """DDPM's draws and the caption drop vector ~ Bernoulli(cond_drop_prob)
        [B] (bool)."""
        draws = super().draw_training_inputs(shape, generator)
        draws["cond_drop"] = torch.rand((shape[0],), generator=generator, device=self.device) < self.cond_drop_prob
        return draws

    def training_step(self, params, batch, draws):
        """DDPM's step with the batch's captions, those where ``cond_drop``
        is true dropped to the null context."""
        self._check_training_options()
        proc = preprocess_batch(batch, self.device, flip=draws["flip"])
        model_fn = self.get_model_fn(proc, training=True, cond_drop=draws["cond_drop"],
                                     dropout_masks=self.dropout_masks(draws))
        return self.training_loss(params, proc["pixel_values"], draws["t"], self.training_noise(draws), model_fn)

    # ---- inference -----------------------------------------------------------
    def _cfg_forward(self, params, x, t, context, negative, guidance_scale: torch.Tensor):
        """The guided network: one call on ``[x, x]`` with contexts
        ``[context, negative]``; ε_a + w·(ε_c − ε_a) (the ε half only, with
        the conditional variance, for a learned-variance output). ``w`` is a
        float32 0-d tensor on the device, read where a captured chain keeps
        it."""
        w = guidance_scale
        tt = torch.cat([t, t]) if t.ndim == 1 else t
        out = self.model_fn(params, torch.cat([x, x]), tt, context=torch.cat([context, negative]))
        out_c, out_u = out.chunk(2, dim=0)
        if out_c.shape[-1] == 2 * x.shape[-1]:
            eps_c, var_c = out_c.chunk(2, dim=-1)
            eps_u = out_u.chunk(2, dim=-1)[0]
            return torch.cat([eps_u + w * (eps_c - eps_u), var_c], dim=-1)
        return out_u + w * (out_c - out_u)

    def _float_context(self, batch_size: int, context) -> torch.Tensor:
        """An outside encoder's float context [B, L, D] (or [L, D], broadcast)
        as a float32 tensor on the device, with the JAX package's checks."""
        ctx = context if torch.is_tensor(context) else torch.from_numpy(np.asarray(context, np.float32))
        ctx = ctx.to(device=self.device, dtype=torch.float32)
        if ctx.ndim == 2:
            ctx = ctx[None].expand(batch_size, -1, -1).contiguous()
        if ctx.ndim != 3 or ctx.shape[0] != batch_size:
            raise ValueError(f"context must be [B={batch_size}, L, D] or [L, D]; got {tuple(np.shape(context))}")
        if ctx.shape[-1] != self.context_dim:
            raise ValueError(f"context feature dim {ctx.shape[-1]} != model context_dim {self.context_dim}")
        return ctx

    def sample(
        self,
        batch_size: int,
        image_size: int,
        generator: Optional[torch.Generator] = None,
        text: Prompts = None,
        use_ema: bool = False,
        graphs: Optional[bool] = None,
        return_frames: bool = False,
        guidance_scale: Optional[float] = None,
        negative_text: Prompts = None,
        context=None,
    ):
        """Prompted sampling (``text=None``: the null context).
        ``guidance_scale`` guides (needs a prompt; w = 1 is the prompted
        chain up to rounding); ``negative_text`` replaces the null context
        as the guidance anchor (needs ``guidance_scale``); ``context`` is a
        float [B, L, context_dim] or [L, context_dim] sequence in place of
        the prompts (guided against zeros). Returns [B, H, W, C] in [0, 1]
        (and the trajectory under ``return_frames``, as ``DDPM.sample``)."""
        if context is not None:
            if text is not None or negative_text is not None:
                raise ValueError("context= replaces text prompts; pass either an external float context or "
                                 "text/negative_text, not both")
            tokens = self._float_context(batch_size, context)
            negative = torch.zeros_like(tokens)
        elif guidance_scale is not None and text is None:
            raise ValueError("guidance_scale requires a text prompt")
        if negative_text is not None and guidance_scale is None:
            raise ValueError("negative_text requires guidance_scale")
        if context is None:
            tokens = self._tokens_array(batch_size, text)
            negative = self._tokens_array(batch_size, negative_text)
        if guidance_scale is None:
            model_fn = Conditioned(self.model_fn, {"context": tokens})
        else:
            scale = torch.tensor(float(guidance_scale), dtype=torch.float32, device=self.device)
            model_fn = Conditioned(self._cfg_forward, {"context": tokens, "negative": negative,
                                                       "guidance_scale": scale})
        shape = (batch_size, image_size, image_size, int(self.channels))
        params = self.ema_params if use_ema else self.params
        with torch.inference_mode():
            return self.sampler.p_sample_loop(model_fn, params, shape, generator, graphs=graphs,
                                              return_frames=return_frames)

    def interpolate(self, x1, x2, t=None, lambd: float = 0.5, generator=None, graphs=None,
                    return_frames: bool = False, text: Prompts = None, model_fn=None):
        """``DDPM.interpolate`` with ``text``'s tokens bound (the null
        context without a prompt)."""
        tokens = {"context": self._tokens_array(x1.shape[0], text)}
        return super().interpolate(x1, x2, t=t, lambd=lambd, generator=generator, graphs=graphs,
                                   return_frames=return_frames, model_fn=Conditioned(self.model_fn, tokens))
