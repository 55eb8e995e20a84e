"""The port's WaveGrad vocoder (mel → waveform) against the JAX package, on
the CPU.

The model is the one of tests/test_wavegrad_vocoder.py: hop 60 = 5·3·2·2,
16 mels, 4-frame (240-sample) segments, channels 4-16, T = 10, float32; the
port's weights are the JAX ``init_params`` carried over with
``utils/weights.py``. Inputs are made with numpy from a seed; the training
step's draws (the level's s and u, the noise) are re-derived from the JAX
step's key, and a chain's noise from the JAX scan's.

Tolerances: the filterbank and the synthetic waveforms exactly equal, the
Hann window within 1e-7 (XLA's cos and torch's differ by an ulp); the
STFT magnitude 1e-4 relative (XLA:CPU's and torch's rFFT round
differently; float32 on both sides); log-mel 1e-4 absolute where the mel
energy is above 1e-3 and 1e-3 below it (the log magnifies the FFT's
rounding near the 1e-5 floor); a module or the network 2e-4 relative L2;
the loss 1e-5 relative; the gradient 2e-2 relative L2 (the L1 loss's
gradient is the sign of each residual: a residual within rounding of 0
flips); a chain 1e-3.
"""

import copy
import io
import json
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_model_nemo_tpu.config import from_dict as j_from_dict
from diffusion_model_nemo_tpu.data.hf_vision_data import SyntheticAudioDataset as JAudio
from diffusion_model_nemo_tpu.data.hf_vision_data import build_dataloader as j_build_dataloader
from diffusion_model_nemo_tpu.models import WavegradVocoderModel as JVocoder
from diffusion_model_nemo_tpu.models import restore_model_from_archive as j_restore
from diffusion_model_nemo_tpu.modules import wavegrad_audio as JA
from diffusion_model_nemo_tpu.ops import audio as JO
from diffusion_model_nemo_tpu.training.checkpoints import load_archive as j_load_archive
from diffusion_model_nemo_tpu_torch.cli import train_vocoder, vocode
from diffusion_model_nemo_tpu_torch.config import from_dict
from diffusion_model_nemo_tpu_torch.data import SyntheticAudioDataset, build_dataloader
from diffusion_model_nemo_tpu_torch.models import WavegradVocoderModel, restore_model_from_archive
from diffusion_model_nemo_tpu_torch.modules import gaussian_diffusion as TG
from diffusion_model_nemo_tpu_torch.modules import wavegrad_audio as TA
from diffusion_model_nemo_tpu_torch.ops import audio as TO
from diffusion_model_nemo_tpu_torch.serving import serve
from diffusion_model_nemo_tpu_torch.training import Trainer
from diffusion_model_nemo_tpu_torch.utils.weights import from_flax_params

HOP, SEG_FRAMES, N_MELS, N_FFT, T = 60, 4, 16, 128, 10
SEG = HOP * SEG_FRAMES
B = 3
WHOLE_TOL = 2e-4
GRAD_TOL = 2e-2
CHAIN_TOL = 1e-3
CFG = {
    "timesteps": T, "channels": 1, "image_size": 0, "save_every": 0,
    "audio": {"sample_rate": 8000, "n_fft": N_FFT, "hop": HOP, "n_mels": N_MELS, "segment_frames": SEG_FRAMES},
    "train_ds": {"name": "synthetic_audio", "segment_length": SEG, "length": 8, "batch_size": 2, "shuffle": True},
    "diffusion_model": {
        "_target_": "diffusion_model_nemo.modules.WaveGradVocoder", "n_mels": N_MELS, "hop": HOP,
        "upsample_factors": [5, 3, 2, 2], "up_channels": [16, 16, 8, 8], "down_channels": [8, 8, 16],
        "base_channels": 4,
    },
    "sampler": {
        "_target_": "diffusion_model_nemo.modules.WaveGradDiffusion", "timesteps": T, "schedule_name": "linear",
        "schedule_cfg": {"linear": {"beta_start": 1e-4, "beta_end": 0.05}},
    },
    "loss": {"_target_": "diffusion_model_nemo.loss.DiffusionLoss", "loss_type": "l1"},
    "optim": {"name": "adamw", "lr": 1e-3},
}
CLI_TINY = [
    f"model.timesteps={T}", f"model.audio.sample_rate=8000", f"model.audio.n_fft={N_FFT}", f"model.audio.hop={HOP}",
    f"model.audio.n_mels={N_MELS}", f"model.audio.segment_frames={SEG_FRAMES}", f"model.train_ds.segment_length={SEG}",
    "model.train_ds.length=8", "model.train_ds.batch_size=2", f"model.diffusion_model.n_mels={N_MELS}",
    f"model.diffusion_model.hop={HOP}", "model.diffusion_model.upsample_factors=[5,3,2,2]",
    "model.diffusion_model.up_channels=[16,16,8,8]", "model.diffusion_model.down_channels=[8,8,16]",
    "model.diffusion_model.base_channels=4", "model.diffusion_model.dtype=float32",
]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _waves(seed=0, n=B):
    """Tones plus a little noise in [-1, 1] (a realistic mel range)."""
    rng = np.random.default_rng(seed)
    t = np.arange(SEG) / 8000.0
    f0 = rng.uniform(100, 1500, (n, 1))
    w = np.sin(2 * np.pi * f0 * t) * 0.6 + rng.standard_normal((n, SEG)) * 0.02
    return w.astype(np.float32)


@pytest.fixture(scope="module")
def pair():
    jmodel = JVocoder(cfg=j_from_dict(copy.deepcopy(CFG)))
    y, mel = jnp.zeros((1, SEG, 1)), jnp.zeros((1, SEG_FRAMES, N_MELS))
    jmodel.params = jax.jit(jmodel.diffusion_model.init)(jax.random.PRNGKey(0), y, jnp.full((1, 1, 1), 0.5), mel)[
        "params"]
    jmodel.ema_params = jax.tree.map(jnp.copy, jmodel.params)
    model = WavegradVocoderModel(from_dict(copy.deepcopy(CFG)), device="cpu")
    model._load_flax(jax.tree.map(np.asarray, jmodel.params), None)
    return jmodel, model


# ---------------------------------------------------------------- features --
def test_stft_mel_and_log_mel_match_jax():
    x = _waves(1)
    np.testing.assert_array_equal(TO.mel_filterbank(N_MELS, N_FFT, 8000).numpy(),
                                  np.asarray(JO.mel_filterbank(N_MELS, N_FFT, 8000)))
    np.testing.assert_allclose(TO.hann_window(N_FFT).numpy(), np.asarray(JO.hann_window(N_FFT)), rtol=0, atol=1e-7)
    mag = TO.stft_magnitude(torch.from_numpy(x), n_fft=N_FFT, hop=HOP)
    ref = np.asarray(JO.stft_magnitude(jnp.asarray(x), n_fft=N_FFT, hop=HOP))
    assert mag.shape == ref.shape == (B, SEG // HOP + 1, N_FFT // 2 + 1)
    np.testing.assert_allclose(mag.numpy(), ref, rtol=1e-4, atol=1e-4 * float(ref.max()))
    fb = TO.mel_filterbank(N_MELS, N_FFT, 8000)
    ours = TO.log_mel_spectrogram(torch.from_numpy(x), fb, n_fft=N_FFT, hop=HOP).numpy()
    theirs = np.asarray(JO.log_mel_spectrogram(jnp.asarray(x), jnp.asarray(fb.numpy()), n_fft=N_FFT, hop=HOP))
    loud = theirs > np.log(1e-3)
    np.testing.assert_allclose(ours[loud], theirs[loud], atol=1e-4, rtol=0)
    np.testing.assert_allclose(ours[~loud], theirs[~loud], atol=1e-3, rtol=0)


def test_synthetic_audio_set_and_loader_equal_jax():
    ours, theirs = SyntheticAudioDataset(SEG, 80), JAudio(SEG, 80)
    assert len(ours) == len(theirs) == 80
    for i in (0, 17, 63, 79):
        np.testing.assert_array_equal(ours[i]["audio"], theirs[i]["audio"])
    cfg = dict(CFG["train_ds"])
    for mode in ("train", "test"):
        a, b = next(iter(build_dataloader(cfg, mode))), next(iter(j_build_dataloader(cfg, mode)))
        assert set(a) == {"audio"} and a["audio"].shape == (2, SEG)
        np.testing.assert_array_equal(a["audio"], b["audio"])


# ----------------------------------------------------------------- modules --
def _carry(jmod, variables, tmod):
    tmod.load_state_dict(from_flax_params(jax.tree.map(np.asarray, variables["params"]), tmod))
    return tmod


@pytest.mark.parametrize("case", ["dblock-2", "dblock-3", "dblock-5", "ublock", "film", "encoding"])
def test_modules_match_jax(case):
    """DBlock at each stride (its k3 SAME conv pads (0, 1) at stride 2 and
    nothing at 3 and 5), UBlock with a FiLM, FiLM1D, the level encoding."""
    rng = np.random.default_rng(2)
    level = rng.uniform(0, 1, (B, 1, 1)).astype(np.float32)
    if case == "encoding":
        ref = JA.NoiseLevelEncoding(16).apply({}, jnp.asarray(level))
        ours = TA.NoiseLevelEncoding(16)(torch.from_numpy(level))
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=2e-5, rtol=0)
        return
    if case.startswith("dblock"):
        f = int(case.split("-")[1])
        x = rng.standard_normal((B, 60, 6)).astype(np.float32)
        jmod, tmod, args = JA.DBlock(8, f), TA.DBlock(6, 8, f), (x,)
    elif case == "ublock":
        x = rng.standard_normal((B, 10, 6)).astype(np.float32)
        film = [rng.standard_normal((B, 30, 8)).astype(np.float32) for _ in range(2)]
        jmod, tmod, args = JA.UBlock(8, 3), TA.UBlock(6, 8, 3), (x, tuple(film))
    else:
        x = rng.standard_normal((B, 30, 6)).astype(np.float32)
        jmod, tmod, args = JA.FiLM1D(8), TA.FiLM1D(6, 8), (x, level)
    jargs = jax.tree.map(jnp.asarray, args)
    variables = jmod.init(jax.random.PRNGKey(4), *jargs)
    ref = jmod.apply(variables, *jargs)
    ours = _carry(jmod, variables, tmod)(*jax.tree.map(torch.from_numpy, args))
    for a, b in zip(jax.tree.leaves(ours), jax.tree.leaves(ref)):
        assert a.shape == b.shape and _rel_l2(a.detach().numpy(), b) < WHOLE_TOL


def test_vocoder_forward_matches_jax(pair):
    jmodel, model = pair
    rng = np.random.default_rng(3)
    y = rng.standard_normal((B, SEG, 1)).astype(np.float32)
    mel = rng.standard_normal((B, SEG_FRAMES, N_MELS)).astype(np.float32)
    level = rng.uniform(0, 1, (B, 1, 1)).astype(np.float32)
    ref = jax.jit(lambda p, *a: jmodel.diffusion_model.apply({"params": p}, *a))(
        jmodel.params, jnp.asarray(y), jnp.asarray(level), jnp.asarray(mel))
    ours = model.vocoder_fn(model.params, torch.from_numpy(y), torch.from_numpy(level), torch.from_numpy(mel))
    assert ours.shape == (B, SEG, 1) and _rel_l2(ours.detach().numpy(), ref) < WHOLE_TOL


# ------------------------------------------------------------ training step --
def test_training_step_loss_and_gradient_match_jax(pair):
    jmodel, model = pair
    wav = _waves(4, 4)
    key = jax.random.PRNGKey(5)
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jmodel.training_step(p, {"audio": jnp.asarray(wav)}, key, 0), has_aux=True))(jmodel.params)
    k_level, k_noise, _ = jax.random.split(key, 3)
    k1, k2 = jax.random.split(k_level)
    draws = {
        "s": torch.from_numpy(np.asarray(jax.random.randint(k1, (4,), 1, T + 1))),
        "u": torch.from_numpy(np.asarray(jax.random.uniform(k2, (4,), dtype=jnp.float32))),
        "noise": torch.from_numpy(np.asarray(jax.random.normal(k_noise, (4, SEG, 1), jnp.float32))),
    }
    params = {k: v.clone().requires_grad_(True) for k, v in model.params.items()}
    loss, metrics = model.training_step(params, {"audio": wav}, draws)
    grads = torch.autograd.grad(loss, list(params.values()))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    jflat = from_flax_params(jax.tree.map(np.asarray, jgrads), model.diffusion_model)
    ours = np.concatenate([g.numpy().ravel() for g in grads])
    assert _rel_l2(ours, np.concatenate([jflat[k].numpy().ravel() for k in params])) < GRAD_TOL


# ------------------------------------------------------------------ vocode --
def _jax_chain_noise(key, shape, steps):
    key, init_key = jax.random.split(key)
    draws = [np.asarray(jax.random.normal(init_key, shape, jnp.float32))]
    for _ in range(steps - 1):
        key, sub = jax.random.split(key)
        draws.append(np.asarray(jax.random.normal(sub, (shape[0], int(np.prod(shape[1:]))), jnp.float32))
                     .reshape(shape))
    return draws


@pytest.mark.parametrize("short", [None, 4], ids=["full", "searched-4"])
def test_vocode_chain_matches_jax_and_replays_equal_eager(pair, monkeypatch, short):
    jmodel, model = pair
    jm, m = copy.deepcopy(jmodel), copy.deepcopy(model)
    if short:
        jm.sampler.search_noise_schedule_coefficients(timesteps=short, iters=20, seed=0, verbose=False)
        jm.sampler.change_noise_schedule(verbose=False)
        jm.sampler.compute_constants(short)
        m.sampler.use_searched_schedule(short, 20, seed=0)
        assert m.sampler.schedule_cfg == jm.sampler.schedule_cfg
    steps = m.sampler.timesteps
    wav = _waves(6, 2)
    mel = m.compute_mel(torch.from_numpy(wav))
    np.testing.assert_allclose(mel.numpy(), np.asarray(jm.compute_mel(jnp.asarray(wav))), atol=1e-3)
    key = jax.random.PRNGKey(7)
    ref = np.asarray(jm.vocode(jnp.asarray(mel.numpy()), key=key))
    queue = [torch.from_numpy(d) for d in _jax_chain_noise(key, (2, SEG, 1), steps)]
    monkeypatch.setattr(TG, "_randn", lambda shape, generator, device: queue.pop(0))
    ours = m.vocode(mel, graphs=False)
    assert not queue and ours.shape == (2, SEG)
    np.testing.assert_allclose(ours.numpy(), ref, rtol=CHAIN_TOL, atol=CHAIN_TOL)
    monkeypatch.undo()
    runs = [m.vocode(mel, generator=torch.Generator().manual_seed(1), graphs=g) for g in (False, True, True)]
    assert all(torch.equal(r, runs[0]) for r in runs[1:])
    other = m.vocode(mel.flip(0), generator=torch.Generator().manual_seed(1), graphs=True)  # the mel is refilled
    assert torch.equal(other, m.vocode(mel.flip(0), generator=torch.Generator().manual_seed(1), graphs=False))


def test_sample_needs_mel_and_mesh_is_not_ported(pair):
    _, model = pair
    with pytest.raises(ValueError, match="mel="):
        model.sample(2)
    with pytest.raises(NotImplementedError, match="parallelism"):
        model.vocode(torch.zeros(1, SEG_FRAMES, N_MELS), mesh=object())
    assert model._save_image_step(4, 1) is None


def test_archives_restore_both_ways(pair, tmp_path):
    jmodel, model = pair
    rng = np.random.default_rng(8)
    y, mel = rng.standard_normal((B, SEG, 1)).astype(np.float32), rng.standard_normal((B, SEG_FRAMES, N_MELS))
    level = rng.uniform(0, 1, (B, 1, 1)).astype(np.float32)
    mel = mel.astype(np.float32)
    apply = jax.jit(lambda p, *a: jmodel.diffusion_model.apply({"params": p}, *a))
    ref = np.asarray(apply(jmodel.params, jnp.asarray(y), jnp.asarray(level), jnp.asarray(mel)))
    restored = restore_model_from_archive(jmodel.save_to(str(tmp_path / "jax.dmn")), device="cpu")
    assert type(restored) is WavegradVocoderModel and restored.hop == HOP
    ours = restored.vocoder_fn(restored.params, *map(torch.from_numpy, (y, level, mel))).detach().numpy()
    assert _rel_l2(ours, ref) < WHOLE_TOL
    path = model.save_to(str(tmp_path / "port.dmn"))
    assert j_load_archive(path)[3] == {"model_class": "WavegradVocoderModel"}
    back = j_restore(path)
    assert type(back).__name__ == "WavegradVocoderModel"
    assert _rel_l2(apply(back.params, jnp.asarray(y), jnp.asarray(level), jnp.asarray(mel)), ref) < WHOLE_TOL
    again = restore_model_from_archive(path, device="cpu")
    assert all(torch.equal(again.params[k], v) for k, v in model.params.items())


# ------------------------------------------------ trainer, CLIs, serving --
def test_fit_on_waveforms_captured_equals_eager():
    runs = []
    for graphs in (False, True):
        model = WavegradVocoderModel(from_dict(copy.deepcopy(CFG)), device="cpu")
        trainer = Trainer(max_steps=2, log_every_n_steps=1)
        trainer.fit(model, graphs=graphs)
        runs.append(model)
    assert all(torch.equal(runs[0].params[k], runs[1].params[k]) for k in runs[0].params)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    root = tmp_path_factory.mktemp("vocoder_cli")
    model, trainer = train_vocoder.main([
        *CLI_TINY, "trainer.max_steps=2", "trainer.log_every_n_steps=1", "+trainer.accelerator=cpu",
        f"exp_manager.exp_dir={root / 'exp'}", "exp_manager.create_tensorboard_logger=false",
        "+exp_manager.version=run",
    ])
    dmn = next(trainer.exp_manager_hooks.log_dir.glob("*.dmn"))
    return root, model, trainer, dmn


def test_train_and_vocode_clis(trained, tmp_path):
    _, model, trainer, dmn = trained
    assert [m["global_step"] for m in trainer.logged] == [1, 2]
    assert all(np.isfinite(m["train_loss"]) for m in trainer.logged)
    out_dir, out = vocode.main([f"model_path={dmn}", "batch_size=2", "sample_timesteps=4", "search_iters=20",
                                f"output_dir={tmp_path}", "device=cpu"])
    assert out.shape == (2, SEG) and np.isfinite(out).all()
    assert np.load(out_dir / "vocoded.npy").shape == np.load(out_dir / "reference.npy").shape == (2, SEG)


def _post(srv, path, payload):
    req = urllib.request.Request(f"http://{srv.host}:{srv.port}{path}", data=json.dumps(payload).encode(),
                                 method="POST")
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _mel_b64(mel):
    import base64

    buf = io.BytesIO()
    np.save(buf, mel)
    return base64.b64encode(buf.getvalue()).decode()


def test_serving_vocodes_and_refuses_the_rest(trained):
    """/vocode answers float32 waveforms, a seeded request repeats and
    equals ``vocode`` on its seed; /sample, a bad mel shape or no mel
    answer 400; the DDIM swap raises for a vocoder archive."""
    _, _, _, dmn = trained
    with pytest.raises(ValueError, match="use_ddim_sampler=false"):
        serve(str(dmn), port=0, device="cpu")
    srv = serve(str(dmn), port=0, max_batch=2, use_ddim_sampler=False, device="cpu")
    srv.start_background()
    try:
        mel = np.random.default_rng(9).standard_normal((3, SEG_FRAMES, N_MELS)).astype(np.float32)
        code, body = _post(srv, "/vocode", {"mel_npy": _mel_b64(mel), "seed": 5})
        waves = np.load(io.BytesIO(body))
        assert code == 200 and waves.shape == (3, SEG) and waves.dtype == np.float32
        assert np.array_equal(np.load(io.BytesIO(_post(srv, "/vocode", {"mel_npy": _mel_b64(mel), "seed": 5})[1])),
                              waves)
        model = srv.batcher.model
        direct = model.vocode(torch.from_numpy(mel[:2]), generator=torch.Generator().manual_seed(5), use_ema=True)
        assert np.array_equal(waves[:2], direct.numpy())
        assert _post(srv, "/sample", {"num_images": 1})[0] == 400
        assert _post(srv, "/vocode", {"mel_npy": _mel_b64(mel[:, :2])})[0] == 400
        assert _post(srv, "/vocode", {})[0] == 400
        images = np.zeros((1, 8, 8, 1), np.uint8)
        code, body = _post(srv, "/edit", {"images_npy": _mel_b64(images), "strength": 0.5})
        assert code == 400 and b"generation archive" in body  # the JAX server's answer
    finally:
        srv.shutdown()
