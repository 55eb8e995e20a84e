"""The port's cascade pipeline and SR3's three CLIs on the CPU.

The base is ``examples/configs/ddpm/unet_small.yaml`` and the upscalers
``examples/configs/sr3/unet_small.yaml``, cut to tiny float32 U-Nets (dim
8, dim_mults [1, 2], T = 6): a 4 px base, SR3 4 → 8 and 8 → 16. What is
held:

- the random-stream contract (``pipelines/cascade.py``): a cascade equals
  its stages run by hand with ``stage_generator(seed, i)``, bit for bit,
  and adding an upscaler changes no earlier stage;
- the geometry and type checks, each as the JAX pipeline refuses it;
- ``from_archives`` restores a cascade that samples as the objects it was
  saved from;
- ``train_sr3`` on a ``name: file`` npz dataset (a sample dump from the
  dataset's LRs, bits/dim, the archive), ``eval_sr3`` (its PNGs equal
  ``super_resolve`` of the degraded inputs, its PSNR ``SR3.psnr``, DDIM
  and DPM-Solver++ swaps) and ``cascade_sr3`` (equal to the pipeline with
  the CLI's swaps).
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from diffusion_model_nemo_tpu.config import load_config as j_load_config
from diffusion_model_nemo_tpu.models import DDPM as JDDPM
from diffusion_model_nemo_tpu.models import SR3 as JSR3
from diffusion_model_nemo_tpu.pipelines import CascadePipeline as JCascadePipeline
from diffusion_model_nemo_tpu_torch.cli import cascade_sr3, eval_sr3, train_sr3
from diffusion_model_nemo_tpu_torch.config import load_config
from diffusion_model_nemo_tpu_torch.models import DDPM, SR3
from diffusion_model_nemo_tpu_torch.pipelines import CascadePipeline, stage_generator
from diffusion_model_nemo_tpu_torch.utils.image import decode_png, to_uint8_tensor

REPO = Path(__file__).resolve().parents[1]
DDPM_YAML = REPO / "examples/configs/ddpm/unet_small.yaml"
SR3_YAML = REPO / "examples/configs/sr3/unet_small.yaml"
T = 6
TINY = [f"model.timesteps={T}", "model.diffusion_model.dim=8", "model.diffusion_model.dim_mults=[1,2]",
        "model.diffusion_model.dtype=float32"]
DDIM = "diffusion_model_nemo.modules.GeneralizedGaussianDiffusion"
DPM = "diffusion_model_nemo.modules.DPMSolverDiffusion"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfg(yaml, size, extra=()):
    return load_config(yaml, overrides=[f"model.image_size={size}", *TINY, *extra]).model


def _base(size=4, channels=3):
    return DDPM(_cfg(DDPM_YAML, size, [f"model.channels={channels}"]), device="cpu", seed=0)


def _sr3(size, scale=2, seed=1, channels=3):
    return SR3(_cfg(SR3_YAML, size, [f"model.scale_factor={scale}", f"model.channels={channels}"]), device="cpu",
               seed=seed)


@pytest.fixture(scope="module")
def stages():
    return _base(4), _sr3(8, seed=1), _sr3(16, seed=2)


def test_cascade_equals_its_stages_by_hand_and_growing_it_changes_no_stage(stages):
    base, up1, up2 = stages
    one = CascadePipeline(base, [up1]).sample(3, seed=42, return_stages=True)
    assert [tuple(s.shape) for s in one] == [(3, 4, 4, 3), (3, 8, 8, 3)]
    pipe = CascadePipeline(base, [up1, up2])
    two = pipe.sample(3, seed=42, return_stages=True)
    assert [tuple(s.shape) for s in two] == [(3, 4, 4, 3), (3, 8, 8, 3), (3, 16, 16, 3)]
    assert all(torch.equal(a, b) for a, b in zip(one, two))
    x0 = base.sample(3, 4, generator=stage_generator(42, 0, "cpu"))
    x1 = up1.super_resolve(x0, generator=stage_generator(42, 1, "cpu"))
    x2 = up2.super_resolve(x1, generator=stage_generator(42, 2, "cpu"))
    assert torch.equal(x2, two[-1]) and torch.equal(pipe.sample(3, seed=42), x2)
    assert bool(torch.isfinite(x2).all()) and pipe.final_image_size == 16 and len(pipe.stages) == 3
    assert not torch.equal(pipe.sample(3, seed=43), x2)


def _jax(cls, yaml, size, extra=()):
    return cls(cfg=j_load_config(yaml, overrides=[f"model.image_size={size}", *TINY, *extra]).model)


def _jax_sr3(size, scale, channels=3):
    return _jax(JSR3, SR3_YAML, size, [f"model.scale_factor={scale}", f"model.channels={channels}"])


def test_geometry_and_type_checks_refuse_as_jax(stages):
    base, up1, _up2 = stages
    jbase = _jax(JDDPM, DDPM_YAML, 4)
    cases = [  # (port upscalers, JAX upscalers, error, message)
        ([], [], ValueError, "at least one"),
        ([_sr3(16, scale=2)], [_jax_sr3(16, 2)], ValueError, "geometry mismatch at stage 1"),
        ([_base(8)], [_jax(JDDPM, DDPM_YAML, 8)], TypeError, "not an SR3-style model"),
        ([_sr3(8, channels=1)], [_jax_sr3(8, 2, channels=1)], ValueError, "channel mismatch at stage 1"),
        ([up1, _sr3(32, scale=2)], [_jax_sr3(8, 2), _jax_sr3(32, 2)], ValueError, "geometry mismatch at stage 2"),
    ]
    for ups, jups, err, match in cases:
        with pytest.raises(err, match=match):
            CascadePipeline(base, ups)
        with pytest.raises(err, match=match):
            JCascadePipeline(jbase, jups)


def test_from_archives_samples_as_the_objects_it_was_saved_from(stages, tmp_path):
    base, up1, up2 = stages
    paths = [m.save_to(str(tmp_path / f"{i}.dmn")) for i, m in enumerate(stages)]
    pipe = CascadePipeline.from_archives(paths[0], paths[1:], device="cpu")
    assert type(pipe.base) is DDPM and all(type(u) is SR3 for u in pipe.upscalers)
    ref = CascadePipeline(base, [up1, up2]).sample(2, seed=7)
    assert torch.equal(pipe.sample(2, seed=7), ref)


def test_sr3_clis_train_eval_and_cascade(stages, tmp_path):
    """``train_sr3`` for 2 steps on an npz dataset (a dump and bits/dim at
    step 2, the archive), ``eval_sr3`` on the same file with the DDIM and
    the DPM-Solver++ swaps, ``cascade_sr3`` from a base archive and the
    trained SR3 with the upscaler swap."""
    hr = np.random.default_rng(0).integers(0, 256, (8, 8, 8, 3), dtype=np.uint8)
    np.savez(tmp_path / "hr.npz", images=hr)
    model, trainer = train_sr3.main([
        "model.image_size=8", *TINY, "model.scale_factor=2", "model.train_ds.name=file",
        f"+model.train_ds.path={tmp_path / 'hr.npz'}", "model.train_ds.batch_size=4", "model.train_ds.num_workers=2",
        "trainer.accelerator=cpu", "exp_manager.create_tensorboard_logger=false", "trainer.max_steps=2",
        "model.save_every=2", "model.compute_bpd=true", f"+model.results_dir={tmp_path / 'results'}",
        f"exp_manager.exp_dir={tmp_path / 'exp'}", "+model.cond_aug_std=0.1"])
    assert type(model) is SR3 and np.isfinite(trainer.logged[-1]["train_loss"])
    assert (tmp_path / "results" / "sample-1-1.png").is_file()
    (dmn,) = (tmp_path / "exp").glob("*/*/SR3-UNet.dmn")

    for swap, fields in ((["use_ddim_sampler=true", "ddim_timesteps=3"], dict(_target_=DDIM, eta=0.0,
                                                                                ddim_timesteps=3)),
                         (["use_dpm_solver=true", "dpm_steps=3"], dict(_target_=DPM, solver_steps=3))):
        out, psnr = eval_sr3.main([f"model_path={dmn}", f"input_path={tmp_path / 'hr.npz'}", "batch_size=3",
                                   "device=cpu", f"output_dir={tmp_path / 'sr'}", "add_timestamp=false", "seed=5",
                                   *swap])
        assert sorted(p.name for p in out.iterdir()) == ["hr.png", "lr_upsampled.png", "sr.png", "sr_0.png",
                                                         "sr_1.png", "sr_2.png"]
        back = SR3.restore_from(str(dmn), use_ema=True, device="cpu")
        back.change_sampler(dict(back.cfg.sampler, **fields))
        x = torch.from_numpy(hr[:3].astype(np.float32) / 255.0)
        lr = (back.degrade(x * 2 - 1) + 1) * 0.5
        ref = back.super_resolve(lr, generator=torch.Generator().manual_seed(5))
        pngs = np.stack([decode_png((out / f"sr_{i}.png").read_bytes()) for i in range(3)])
        assert np.array_equal(pngs, to_uint8_tensor(ref).numpy())
        np.testing.assert_array_equal(psnr, back.psnr(ref, x).numpy())

    base_path = _base(4).save_to(str(tmp_path / "base.dmn"))
    out, outs = cascade_sr3.main([f"base_path={base_path}", f"upscaler_paths={dmn}", "batch_size=2", "device=cpu",
                                  f"output_dir={tmp_path / 'c'}", "add_timestamp=false", "seed=3",
                                  "upscaler_ddim_timesteps=3", "use_ddim_sampler=true", "ddim_timesteps=3"])
    assert sorted(p.name for p in out.iterdir()) == ["sample_0.png", "sample_1.png", "samples_grid.png",
                                                     "stage0_4px.png", "stage1_8px.png"]
    pipe = CascadePipeline.from_archives(base_path, [str(dmn)], use_ema=True, device="cpu")
    pipe.base.change_sampler(dict(pipe.base.cfg.sampler, _target_=DDIM, eta=0.0, ddim_timesteps=3))
    pipe.upscalers[0].change_sampler(dict(pipe.upscalers[0].cfg.sampler, _target_=DDIM, eta=0.0, ddim_timesteps=3))
    ref = pipe.sample(2, seed=3, return_stages=True)
    assert all(torch.equal(a, b) for a, b in zip(outs, ref))
    with pytest.raises(ValueError, match="upscaler_paths"):
        cascade_sr3.main([f"base_path={base_path}", "device=cpu"])
    with pytest.raises(ValueError, match="input_path= or dataset_name="):
        eval_sr3.main([f"model_path={dmn}", "device=cpu"])
