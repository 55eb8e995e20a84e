"""The README's usage path on the port, on the CPU: ``train_ddpm`` from
``examples/configs/ddpm/unet_small.yaml`` (sample dump, checkpoints, final
archive), ``eval_ddpm``, ``test_ddpm`` and ``serve`` from the archive, each
CLI called in-process with a tiny U-Net; deterministic resume; the options
that stay refused; the ImprovedDDPM and ConditionalDDPM CLIs (train → eval /
test → serve) with ``restore_model_from_archive`` of each family; and the
sampling services: ``eval_ddpm``'s sampler flags and ``show_diffusion`` (its
GIF decoded), the three interpolation CLIs, ``edit_ddpm`` and
``inpaint_ddpm``.
"""

import json
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

from diffusion_model_nemo_tpu_torch import DDPM, Trainer
from diffusion_model_nemo_tpu_torch.cli import (
    edit_ddpm, eval_conditional_ddpm, eval_ddpm, eval_improved_ddpm, inpaint_ddpm, interpolate_ddim,
    interpolate_ddpm, interpolate_improved_ddpm, serve, test_conditional_ddpm, test_ddpm, test_improved_ddpm,
    train_conditional_ddpm, train_ddpm, train_improved_ddpm,
)
from diffusion_model_nemo_tpu_torch.models import ConditionalDDPM, ImprovedDDPM, restore_model_from_archive
from diffusion_model_nemo_tpu_torch.cli.common import parse_args
from diffusion_model_nemo_tpu_torch.config import load_config
from diffusion_model_nemo_tpu_torch.training import CheckpointManager, exp_manager
from diffusion_model_nemo_tpu_torch.utils.image import decode_png

REPO = Path(__file__).resolve().parents[1]
CONFIG = ["--config-path=examples/configs/ddpm", "--config-name=unet_small.yaml"]
TINY = [
    "model.image_size=8", "model.timesteps=10", "model.diffusion_model.dim=8",
    "model.diffusion_model.dim_mults=[1,2]", "model.train_ds.name=synthetic",
    "model.train_ds.batch_size=4", "+model.train_ds.length=16", "trainer.accelerator=cpu",
    "exp_manager.create_tensorboard_logger=false",
]


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """train_ddpm for 6 steps (dumps at 3 and 6, checkpoints at 3 and 6),
    then resumed to 9 in the same version; returns the run directory, the
    model and the trainer."""
    root = tmp_path_factory.mktemp("cli")
    common = [*CONFIG, *TINY, "model.save_every=3", "model.compute_bpd=false",
              "exp_manager.checkpoint_every_n_steps=3", f"exp_manager.exp_dir={root / 'exp'}",
              "+exp_manager.version=run",
              f"+model.results_dir={root / 'results'}", "trainer.log_every_n_steps=3"]
    first, _ = train_ddpm.main([*common, "trainer.max_steps=6"])
    model, trainer = train_ddpm.main([*common, "trainer.max_steps=9", "exp_manager.resume_if_exists=true"])
    (run,) = (root / "exp" / "DDPM-UNet").iterdir()
    return root, run, first, model, trainer


def test_train_writes_dumps_checkpoints_and_the_archive(trained):
    root, run, _first, _model, trainer = trained
    assert sorted(p.name for p in (root / "results").iterdir()) == [
        "sample-1-1.png", "sample-2-1.png", "sample-3-1.png"]
    grid = decode_png((root / "results" / "sample-1-1.png").read_bytes())
    assert grid.shape == (12, 42, 3)  # 4 images of 8 px in a row, 2 px apart
    assert (run / "hparams.yaml").is_file() and (run / "DDPM-UNet.dmn").is_file()
    assert CheckpointManager(str(run / "checkpoints")).latest_step() == 9
    assert [m["global_step"] for m in trainer.logged] == [9]  # the resumed run starts at 6


def test_resumed_cli_run_starts_from_the_checkpoint(trained):
    _root, run, first, model, _trainer = trained
    state = CheckpointManager(str(run / "checkpoints")).restore(9)
    assert state["step"] == 9 and state["data_position"] == [2, 1]
    assert all(torch.equal(state["params"][k], model.params[k]) for k in model.params)
    assert any(not torch.equal(first.params[k], model.params[k]) for k in model.params)


def test_eval_writes_the_samples_of_ddpm_sample(trained, tmp_path):
    _root, run, *_ = trained
    dmn = str(run / "DDPM-UNet.dmn")
    out = eval_ddpm.main([f"model_path={dmn}", "batch_size=3", "ddim_timesteps=5", "seed=1",
                          "device=cpu", f"output_dir={tmp_path}", "add_timestamp=false"])
    pngs = [decode_png((out / f"sample_{i}.png").read_bytes()) for i in range(3)]
    assert (out / "samples_grid.png").is_file()
    model = DDPM.restore_from(dmn, use_ema=True, device="cpu")
    eval_ddpm.maybe_use_ddim_sampler(model, eval_ddpm.EvalConfig(ddim_timesteps=5))
    ref = model.sample(3, 8, generator=torch.Generator().manual_seed(1))
    ref = (ref.clamp(0, 1) * 255 + 0.5).to(torch.uint8).numpy()
    assert np.array_equal(np.stack(pngs), ref)


def test_test_ddpm_reports_finite_bits_per_dimension(trained):
    _root, run, *_ = trained
    result = test_ddpm.main([f"model_path={run / 'DDPM-UNet.dmn'}", "batch_size=4",
                             "limit_test_batches=1", "device=cpu"])
    assert set(result) == {"test_total_bpd", "test_terms_bpd", "test_prior_bpd"}
    assert np.isfinite(result["test_total_bpd"]) and result["test_total_bpd"] > 0


def test_serve_answers_from_the_archive_path(trained):
    _root, run, *_ = trained
    server = serve.build_server([f"model_path={run / 'DDPM-UNet.dmn'}", "port=0", "max_batch=2",
                                 "ddim_timesteps=5", "device=cpu"])
    server.start_background()
    try:
        req = urllib.request.Request(f"http://{server.host}:{server.port}/sample", method="POST",
                                     data=json.dumps({"num_images": 2, "format": "png"}).encode())
        with urllib.request.urlopen(req, timeout=120) as resp:
            assert resp.status == 200
            images = json.loads(resp.read())["images"]
    finally:
        server.shutdown()
    import base64

    decoded = np.stack([decode_png(base64.b64decode(p)) for p in images])
    assert decoded.shape == (2, 8, 8, 3)


@pytest.mark.parametrize(
    "cli,args,exc,match",
    [  # the ids of the cases before the trainer's services were ported; an
        # image directory is read since the datasets were ported: an empty one
        # is refused, naming what it lacks
        pytest.param("edit", ["input_path={tmp}"], ValueError, "No image files", id="edit-args3-an image directory"),
        pytest.param("inpaint", ["input_path={tmp}"], ValueError, "No image files",
                     id="inpaint-args4-an image directory"),
        pytest.param("interpolate", ["dataset_name=cifar10"], NotImplementedError, "name='cifar10'",
                     id="interpolate-args5-name='cifar10'"),
    ],
)
def test_refused_options_raise_naming_themselves(trained, tmp_path, cli, args, exc, match):
    _root, run, *_ = trained
    args = [a.format(tmp=tmp_path) for a in args]
    clis = {"edit": edit_ddpm, "inpaint": inpaint_ddpm, "interpolate": interpolate_ddpm}
    with pytest.raises(exc, match=match):
        clis[cli].main([f"model_path={run / 'DDPM-UNet.dmn'}", "device=cpu", "batch_size=2", *args])


@pytest.mark.parametrize(
    "args,warning",
    [
        (["trainer.accumulate_grad_batches=2"], None),
        (["+trainer.steps_per_execution=2", "trainer.accumulate_grad_batches=2"], "accumulate_grad_batches > 1"),
        (["+trainer.posthoc_ema_sigma_rels=[0.05]"], None),
        (["+trainer.steps_per_execution=2", "+trainer.posthoc_ema_sigma_rels=[0.05]"], "posthoc_ema is unsupported"),
    ],
    ids=["accumulate", "steps_per_execution-accumulate", "posthoc", "steps_per_execution-posthoc"],
)
def test_train_passes_the_trainer_services_through(tmp_path, caplog, args, warning):
    """A 1-step ``train_ddpm`` with each trainer key of the services (no new
    flag: the ``trainer`` block goes to ``Trainer`` as it is): accumulation
    stacks two micro-batches into the step and wins over
    ``steps_per_execution`` with the JAX trainer's warning; post-hoc EMA
    writes its final snapshot under the run directory, and is disabled with
    its warning beside ``steps_per_execution``."""
    with caplog.at_level("WARNING"):
        _model, trainer = train_ddpm.main([*CONFIG, *TINY, "trainer.max_steps=1",
                                           f"exp_manager.exp_dir={tmp_path}", *args])
    assert [m["global_step"] for m in trainer.logged] == [1]
    warned = [r.getMessage() for r in caplog.records if r.levelname == "WARNING"]
    assert any(warning in w for w in warned) if warning else not warned, warned
    if "accumulate" in " ".join(args):
        assert trainer.accumulate_grad_batches == 2 and trainer.steps_per_execution == 1
    snaps = sorted(tmp_path.rglob("phema-*.msgpack"))
    posthoc = "posthoc" in " ".join(args) and warning is None
    assert len(snaps) == (1 if posthoc else 0), snaps
    if posthoc:  # the run's final snapshot, in <run dir>/phema
        assert snaps[0].name.endswith("-0000000001.msgpack") and snaps[0].parent.name == "phema"


class _Clock:
    """Stands in for the ``datetime`` module of both exp_managers: each call
    of ``datetime.now()`` is one second after the last."""

    def __init__(self):
        self.calls = 0
        self.datetime = self

    def now(self):
        import datetime

        self.calls += 1
        return datetime.datetime(2026, 1, 1, 0, 0, self.calls)


def _exp_layout(root):
    return sorted(str(p.relative_to(root)) for p in root.rglob("*"))


def test_exp_manager_versions_follow_the_jax_package(tmp_path, monkeypatch):
    """The exp_manager blocks of two train CLI calls, the second with
    ``resume_if_exists=true`` and no ``version``, through both packages'
    exp_manager: each call makes a new datetime version (the second resumes
    nothing), and the two directory trees are the same."""
    import importlib
    from types import SimpleNamespace

    j_exp = importlib.import_module("diffusion_model_nemo_tpu.training.exp_manager")
    t_exp = importlib.import_module("diffusion_model_nemo_tpu_torch.training.exp_manager")

    layouts, states = {}, {}
    for name, module in (("jax", j_exp), ("port", t_exp)):
        monkeypatch.setattr(module, "datetime", _Clock())
        root = tmp_path / name
        common = [f"exp_manager.exp_dir={root}", "exp_manager.create_tensorboard_logger=false",
                  "exp_manager.checkpoint_every_n_steps=3"]
        for extra in ([], ["exp_manager.resume_if_exists=true"]):
            cfg = load_config(REPO / "examples/configs/ddpm/unet_small.yaml", overrides=[*common, *extra])
            hooks = module.exp_manager(SimpleNamespace(), cfg.exp_manager)
            states.setdefault(name, []).append(hooks.resume_state)
        layouts[name] = _exp_layout(root)
    assert layouts["port"] == layouts["jax"]
    assert states["port"] == states["jax"] == [None, None]
    runs = sorted(p.name for p in (tmp_path / "port" / "DDPM-UNet").iterdir())
    assert runs == ["2026-01-01_00-00-01", "2026-01-01_00-00-02"]


def test_train_cli_runs_steps_per_execution_at_k_boundaries(tmp_path):
    """``+trainer.steps_per_execution=2``: five steps as two groups of two
    and a single tail step; the log (every 3), the sample dump (every 4)
    and the NaN check come at group boundaries by the JAX trainer's
    ``_crossed`` rule; the last checkpoint is the final step's."""
    model, trainer = train_ddpm.main([
        *CONFIG, *TINY, "+trainer.steps_per_execution=2", "trainer.max_steps=5", "trainer.log_every_n_steps=3",
        "model.save_every=4", "model.compute_bpd=false", f"+model.results_dir={tmp_path / 'results'}",
        "exp_manager.checkpoint_every_n_steps=3", f"exp_manager.exp_dir={tmp_path / 'exp'}",
        "+exp_manager.version=run"])
    assert trainer.steps_per_execution == 2 and trainer.global_step == 5
    assert [m["global_step"] for m in trainer.logged] == [4, 5]
    assert sorted(p.name for p in (tmp_path / "results").iterdir()) == ["sample-1-1.png"]
    assert CheckpointManager(str(tmp_path / "exp/DDPM-UNet/run/checkpoints")).latest_step() == 5
    assert all(np.isfinite(m["train_loss"]) for m in trainer.logged)


def test_cli_config_errors_name_the_key():
    with pytest.raises(ValueError, match="model.image_size"):
        train_ddpm.main([*CONFIG, "trainer.accelerator=cpu"])
    with pytest.raises(KeyError, match="use_nothing"):
        eval_ddpm.main(["use_nothing=true"])


def _resume_cfg():
    # A constant learning rate, as in the JAX package's resume test: the
    # cosine schedule is a function of max_steps, which the interrupted run
    # (3) and the continuous one (6) do not share.
    overrides = [*TINY[:7], "model.optim.sched=null"]
    return load_config(REPO / "examples/configs/ddpm/unet_small.yaml", overrides=overrides).model


def _exp(root, resume):
    return {"exp_dir": str(root), "name": "R", "version": "v0", "create_tensorboard_logger": False,
            "checkpoint_every_n_steps": 3, "checkpoint_callback_params": {"save_top_k": 1},
            "resume_if_exists": resume, "resume_ignore_no_checkpoint": True}


def test_resumed_run_is_bitwise_identical_to_a_continuous_one(tmp_path):
    """6 steps straight through against 3, a checkpoint, a new Trainer that
    resumes and 3 more (4 batches an epoch: the run crosses an epoch):
    params, EMA, optimizer state and the draw generator bit for bit."""
    cont = DDPM(_resume_cfg(), device="cpu", seed=0)
    t0 = Trainer(max_steps=6, devices=1)
    exp_manager(t0, _exp(tmp_path / "a", False))
    t0.fit(cont)

    m1 = DDPM(_resume_cfg(), device="cpu", seed=0)
    t1 = Trainer(max_steps=3, devices=1)
    exp_manager(t1, _exp(tmp_path / "b", False))
    t1.fit(m1)
    m2 = DDPM(_resume_cfg(), device="cpu", seed=7)  # other weights: the resume overwrites them
    t2 = Trainer(max_steps=6, devices=1)
    hooks = exp_manager(t2, _exp(tmp_path / "b", True))
    assert hooks.resume_state["step"] == 3
    t2.fit(m2, resume_state=hooks.resume_state)

    a = CheckpointManager(str(tmp_path / "a/R/v0/checkpoints")).restore(6)
    b = CheckpointManager(str(tmp_path / "b/R/v0/checkpoints")).restore(6)
    for key in ("params", "ema_params"):
        assert all(torch.equal(a[key][k], b[key][k]) for k in a[key]), key
    for key in ("mu", "nu"):
        assert all(torch.equal(a["opt_state"][key][k], b["opt_state"][key][k]) for k in a["opt_state"][key])
    assert a["opt_state"]["count"] == b["opt_state"]["count"] == 6
    assert torch.equal(a["generator"], b["generator"]) and a["data_position"] == b["data_position"] == [1, 2]
    assert all(torch.equal(cont.params[k], m2.params[k]) for k in cont.params)
    assert all(torch.equal(cont.ema_params[k], m2.ema_params[k]) for k in cont.ema_params)
    moved = DDPM(_resume_cfg(), device="cpu", seed=0)
    assert any(not torch.equal(moved.params[k], cont.params[k]) for k in cont.params)


def test_tensorboard_image_summary_needs_no_pillow(tmp_path, monkeypatch):
    """exp_manager's sample grids reach TensorBoard through the port's PNG
    codec: with Pillow unimportable the image summary is still written and
    decodes to the grid (TensorFlow blocked too: TensorBoard's stub is
    enough, and TensorFlow, where installed, takes seconds to import)."""
    import sys

    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    monkeypatch.setitem(sys.modules, "PIL", None)
    monkeypatch.setitem(sys.modules, "tensorflow", None)
    hooks = exp_manager(Trainer(), {"exp_dir": str(tmp_path), "name": "tb", "version": "v"})
    images = np.random.default_rng(0).random((4, 8, 8, 3))
    hooks.log_images("samples", images, 3)
    hooks.log_metrics({"train_loss": 0.5}, 3)
    hooks.tb_writer.flush()
    events = EventAccumulator(str(tmp_path / "tb/v/tensorboard"))
    events.Reload()
    (image,) = events.Images("samples")
    grid = decode_png(image.encoded_image_string)
    assert image.step == 3 and grid.shape == (12, 42, 3)
    assert np.array_equal(grid[2:10, 2:10], (images[0] * 255 + 0.5).astype(np.uint8))
    assert [e.value for e in events.Scalars("train_loss")] == [0.5]


# ----------------------------------------------------- the two new families --
FAMILY_TINY = [t for t in TINY if not t.startswith("+model.train_ds.length")] + [
    "+model.train_ds.length=8", "trainer.max_steps=2", "model.timesteps=5"]


@pytest.fixture(scope="module")
def family_archives(tmp_path_factory):
    """train_improved_ddpm and train_conditional_ddpm (K = 10) for 2 steps
    each at a tiny width: their archives."""
    root = tmp_path_factory.mktemp("families")
    out = {}
    for name, cli, extra in (("improved", train_improved_ddpm, []),
                             ("conditional", train_conditional_ddpm, ["model.num_classes=10"])):
        model, trainer = cli.main([*FAMILY_TINY, *extra, f"exp_manager.exp_dir={root / name}",
                                   "+exp_manager.version=run"])
        assert all(np.isfinite(m["train_loss"]) for m in trainer.logged)
        out[name] = (next((root / name).glob("*/run/*.dmn")), trainer.logged[-1])
    return out


def test_family_train_clis_log_their_metrics(family_archives):
    assert {"simple_loss", "vb_losses", "decoder_nll"} <= set(family_archives["improved"][1])
    assert "simple_loss" not in family_archives["conditional"][1]


@pytest.mark.parametrize("name,cls", [("improved", ImprovedDDPM), ("conditional", ConditionalDDPM)])
def test_restore_model_from_archive_picks_each_family(family_archives, name, cls):
    model = restore_model_from_archive(str(family_archives[name][0]), device="cpu")
    assert type(model) is cls


def test_improved_eval_and_test_clis(family_archives, tmp_path):
    dmn = family_archives["improved"][0]
    out = eval_improved_ddpm.main([f"model_path={dmn}", "batch_size=2", "device=cpu", f"output_dir={tmp_path}",
                                   "add_timestamp=false"])
    assert decode_png((out / "samples_grid.png").read_bytes()).shape[-1] == 3
    result = test_improved_ddpm.main([f"model_path={dmn}", "batch_size=4", "limit_test_batches=1", "device=cpu"])
    assert np.isfinite(result["test_total_bpd"]) and result["test_total_bpd"] > 0
    with pytest.raises(ValueError, match="learned-variance"):  # as the JAX package's DDIM step fails
        eval_improved_ddpm.main([f"model_path={dmn}", "batch_size=2", "device=cpu", "use_ddim_sampler=true",
                                 "ddim_timesteps=5", f"output_dir={tmp_path}"])


def test_conditional_eval_test_and_serve_clis(family_archives, tmp_path):
    dmn = family_archives["conditional"][0]
    out = eval_conditional_ddpm.main([f"model_path={dmn}", "batch_size=2", "device=cpu", "label=3",
                                      "guidance_scale=3.0", "ddim_timesteps=5", f"output_dir={tmp_path}",
                                      "add_timestamp=false"])
    assert (out / "samples_class3.png").is_file()
    result = test_conditional_ddpm.main([f"model_path={dmn}", "batch_size=4", "limit_test_batches=1",
                                         "device=cpu"])
    assert np.isfinite(result["test_total_bpd"])
    server = serve.build_server([f"model_path={dmn}", "port=0", "max_batch=2", "ddim_timesteps=5", "device=cpu"])
    server.start_background()
    try:
        req = urllib.request.Request(f"http://{server.host}:{server.port}/sample", method="POST",
                                     data=json.dumps({"num_images": 2, "label": 3, "format": "npy"}).encode())
        with urllib.request.urlopen(req, timeout=120) as resp:
            assert resp.status == 200
            images = np.load(__import__("io").BytesIO(resp.read()))
    finally:
        server.shutdown()
    assert images.shape == (2, 8, 8, 3) and images.dtype == np.uint8


# ------------------------------------------------------ the sampling services --
@pytest.mark.parametrize("flags,target", [
    (["use_dpm_solver=true", "dpm_steps=4"], "DPMSolverDiffusion"),
    (["use_karras_sampler=true", "karras_steps=3"], "KarrasDiffusion"),
    (["use_unipc=true", "unipc_steps=4", "unipc_order=3", "unipc_variant=bh1"], "UniPCDiffusion"),
    (["use_unipc=true", "unipc_steps=4", "use_dpm_solver=true"], "UniPCDiffusion"),
], ids=["dpm", "karras", "unipc", "unipc-over-dpm"])
def test_eval_sampler_flags_write_the_samples_of_that_sampler(trained, tmp_path, flags, target):
    """``eval_ddpm``'s sampler flags (UniPC > Karras > DPM-Solver++ > DDIM):
    the PNGs are the swapped sampler's ``DDPM.sample`` on the seed."""
    _root, run, *_ = trained
    dmn = str(run / "DDPM-UNet.dmn")
    argv = [f"model_path={dmn}", "batch_size=2", "seed=1", "device=cpu", f"output_dir={tmp_path}",
            "add_timestamp=false", *flags]
    out = eval_ddpm.main(argv)
    pngs = np.stack([decode_png((out / f"sample_{i}.png").read_bytes()) for i in range(2)])
    model = DDPM.restore_from(dmn, use_ema=True, device="cpu")
    eval_ddpm.maybe_use_ddim_sampler(model, eval_ddpm.EvalConfig(**parse_args(argv, schema=eval_ddpm.EvalConfig)))
    assert type(model.sampler).__name__ == target
    ref = model.sample(2, 8, generator=torch.Generator().manual_seed(1))
    assert np.array_equal(pngs, (ref.clamp(0, 1) * 255 + 0.5).to(torch.uint8).numpy())


@pytest.mark.parametrize("flags,frames", [(["use_ddim_sampler=false"], 10), (["ddim_timesteps=5", "frame_step=2"], 3)],
                         ids=["ancestral", "ddim-every-2nd"])
def test_eval_show_diffusion_writes_the_first_samples_trajectory(trained, tmp_path, flags, frames):
    """``show_diffusion``: ``diffusion.gif`` (the port's own encoder, decoded
    here with Pillow), every ``frame_step``-th frame of the first sample,
    the last frame the first PNG up to the GIF palette."""
    from PIL import Image

    _root, run, *_ = trained
    out = eval_ddpm.main([f"model_path={run / 'DDPM-UNet.dmn'}", "batch_size=2", "seed=1", "device=cpu",
                          f"output_dir={tmp_path}", "add_timestamp=false", "show_diffusion=true", *flags])
    gif = Image.open(out / "diffusion.gif")
    assert gif.format == "GIF" and gif.size == (8, 8) and gif.n_frames == frames
    gif.seek(gif.n_frames - 1)
    last = np.asarray(gif.convert("RGB")).astype(np.int32)
    first = decode_png((out / "sample_0.png").read_bytes()).astype(np.int32)
    if frames == 10:  # the ancestral chain's 10 frames: the last is the output
        assert np.abs(last - first).max() <= 26  # the 6 x 7 x 6 colour cube's half step


def test_interpolation_clis(trained, family_archives, tmp_path):
    """``interpolate_ddpm`` (and ImprovedDDPM's) on the synthetic set and
    ``interpolate_ddim`` (slerp): their grids."""
    _root, run, *_ = trained
    dmn = str(run / "DDPM-UNet.dmn")
    out = interpolate_ddpm.main([f"model_path={dmn}", "batch_size=2", "t=5", "lambd=0.25", "device=cpu",
                                 "dataset_name=synthetic", f"output_dir={tmp_path / 'a'}"])
    grids = [decode_png((out / f).read_bytes()) for f in ("interpolation.png", "endpoint_a.png", "endpoint_b.png")]
    assert all(g.shape == (12, 22, 3) for g in grids)
    out = interpolate_improved_ddpm.main([f"model_path={family_archives['improved'][0]}", "batch_size=2",
                                          "device=cpu", "dataset_name=synthetic", f"output_dir={tmp_path / 'b'}"])
    assert decode_png((out / "interpolation.png").read_bytes()).shape == (12, 22, 3)
    out = interpolate_ddim.main([f"model_path={dmn}", "num_interpolations=3", "ddim_timesteps=5", "device=cpu",
                                 f"output_dir={tmp_path / 'c'}"])
    assert decode_png((out / "slerp.png").read_bytes()).shape == (12, 32, 3)


def test_slerp_follows_the_great_circle():
    z1, z2 = torch.randn(4, 4, 3, generator=torch.Generator().manual_seed(0)), torch.randn(
        4, 4, 3, generator=torch.Generator().manual_seed(1))
    assert torch.allclose(interpolate_ddim.slerp(z1, z2, 0.0), z1, atol=1e-5)
    assert torch.allclose(interpolate_ddim.slerp(z1, z2, 1.0), z2, atol=1e-5)
    mid = interpolate_ddim.slerp(z1 / z1.norm(), z2 / z2.norm(), 0.5)
    assert abs(float(mid.norm()) - 1.0) < 1e-5


@pytest.mark.parametrize("source", ["self", "npy", "npz"])
def test_edit_and_inpaint_clis(trained, tmp_path, source):
    """``edit_ddpm`` and ``inpaint_ddpm`` on images sampled from the model
    or read from a .npy / .npz file (uint8 NCHW / [0, 1] floats NHWC): their
    grids and PNGs; the inpainted images keep the known pixels."""
    _root, run, *_ = trained
    dmn = str(run / "DDPM-UNet.dmn")
    imgs = np.random.default_rng(0).uniform(0, 1, (3, 8, 8, 3)).astype(np.float32)
    extra = []
    if source == "npy":
        np.save(tmp_path / "in.npy", imgs)
        extra = [f"input_path={tmp_path / 'in.npy'}"]
    elif source == "npz":
        np.savez(tmp_path / "in.npz", images=(imgs * 255 + 0.5).astype(np.uint8).transpose(0, 3, 1, 2))
        extra = [f"input_path={tmp_path / 'in.npz'}"]
    common = [f"model_path={dmn}", "batch_size=2", "device=cpu", "add_timestamp=false", "seed=2", *extra]
    out = edit_ddpm.main([*common, "strength=0.5", f"output_dir={tmp_path / 'edit'}"])
    assert {p.name for p in out.iterdir()} == {"input.png", "edited.png", "edited_0.png", "edited_1.png"}
    out = inpaint_ddpm.main([*common, "mask=left", "jump_length=2", "jump_n_sample=2",
                             f"output_dir={tmp_path / 'inpaint'}"])
    names = {p.name for p in out.iterdir()}
    assert names == {"input.png", "masked.png", "inpainted.png", "inpainted_0.png", "inpainted_1.png"}
    if source != "self":
        painted = decode_png((out / "inpainted_0.png").read_bytes()).astype(np.int32)
        src = (np.clip(imgs[0], 0, 1) * 255 + 0.5).astype(np.int32)
        assert np.abs(painted[:, 4:] - src[:, 4:]).max() <= 1  # the right half is kept


@pytest.mark.parametrize("name", ["left", "right", "top", "bottom", "center", "random"])
def test_inpaint_named_masks(name):
    """The JAX script's named masks: 1 = keep, the named fraction cut."""
    m = inpaint_ddpm.build_mask(name, (1, 8, 8, 3), 0.5, torch.Generator().manual_seed(0))
    assert m.shape == (1, 8, 8, 1) and set(np.unique(m)) <= {0.0, 1.0}
    holes = {"left": m[0, :, :4], "right": m[0, :, 4:], "top": m[0, :4], "bottom": m[0, 4:],
             "center": m[0, 2:6, 2:6]}
    if name == "random":
        assert 0 < m.sum() < 64
    else:
        assert holes[name].sum() == 0 and m.sum() == 64 - holes[name].size
