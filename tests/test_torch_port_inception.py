"""The port's InceptionV3 FID extractor against the JAX package's, on the CPU.

Each block type (``BasicConv2d``, ``InceptionA``-``E``, both pool variants)
and the whole ``InceptionV3`` at full width with its ``fc`` head, on B = 2
inputs small enough for the CPU (the trunk takes 75 px and up), from the
same variables: every weight and the BatchNorm running statistics drawn
with numpy (so swapped mean and var, a wrong eps or a missed ReLU cannot
hide), carried by ``utils/weights.py:inception_from_flax``. ``preprocess``
on uint8, [0, 1] and [0, 255] floats and grey input, 32 → 299 and the
antialiased 320 → 299. The weight files: a torchvision-named ``.pt`` and a
``.npz``, both written here. ``inception_feature_fn``'s flags, refusals
and logits; its seeded random weights against the JAX package's (they
differ: the PRNG streams do; carried over, the features agree).
``cli/compute_fid.py`` on a tiny archive.

Tolerances, each with its reason:
- blocks and the whole network, float32: 1e-4 relative and absolute (the
  issue's bar; measured ~1e-6: the same convolutions in two libraries);
- ``preprocess``: 32 → 299 at 1e-5; 320 → 299 at 3e-5, because JAX's CPU
  einsum at HIGHEST lands up to 1.3e-5 from the float64 contraction of the
  same weights (the port contracts in float64, ``ops/resize.py``);
- the extractors end to end at 299 px: 1e-4 relative L2.
"""

import io
import re
from contextlib import redirect_stdout
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_model_nemo_tpu.metrics import inception as J
from diffusion_model_nemo_tpu_torch import DDPM
from diffusion_model_nemo_tpu_torch.config import unet_small_model_config
from diffusion_model_nemo_tpu_torch.metrics import inception as T
from diffusion_model_nemo_tpu_torch.utils.weights import inception_from_flax, inception_to_flax

TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _random_variables(module, shape, seed):
    """The module's variable tree (shapes from ``jax.eval_shape``, no init
    compile) with every leaf drawn: kernels N(0, 0.05²), BN scale and var
    U(0.5, 1.5), bias and mean N(0, 0.2²)."""
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), jnp.zeros(shape))
    rng = np.random.RandomState(seed)

    def draw(path, s):
        name = path[-1].key
        if name in ("scale", "var"):
            return rng.uniform(0.5, 1.5, s.shape).astype(np.float32)
        if name in ("bias", "mean"):
            return rng.normal(0.0, 0.2, s.shape).astype(np.float32)
        return rng.normal(0.0, 0.05, s.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _nchw_block(block, x):
    """A port block on NHWC input, NHWC out (the blocks run NCHW inside)."""
    with torch.no_grad():
        return block(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()


BLOCKS = {
    "basic_conv": (lambda: J.BasicConv2d(16, (3, 3), padding=((1, 1), (1, 1))),
                   lambda: T.BasicConv2d(8, 16, 3, padding=1), 8, 9),
    "a_fid": (lambda: J.InceptionA(32, fid_variant=True), lambda: T.InceptionA(48, 32, True), 48, 11),
    "a_plain": (lambda: J.InceptionA(32, fid_variant=False), lambda: T.InceptionA(48, 32, False), 48, 11),
    "b": (lambda: J.InceptionB(), lambda: T.InceptionB(40), 40, 11),
    "c": (lambda: J.InceptionC(64, fid_variant=True), lambda: T.InceptionC(96, 64, True), 96, 9),
    "d": (lambda: J.InceptionD(), lambda: T.InceptionD(64), 64, 11),
    "e_avg": (lambda: J.InceptionE(pool_type="avg"), lambda: T.InceptionE(128, "avg"), 128, 7),
    "e_max": (lambda: J.InceptionE(pool_type="max"), lambda: T.InceptionE(128, "max"), 128, 7),
}


@pytest.mark.parametrize("name", sorted(BLOCKS))
def test_block_matches_jax(name):
    make_j, make_t, cin, hw = BLOCKS[name]
    jblock, tblock = make_j(), make_t()
    variables = _random_variables(jblock, (2, hw, hw, cin), seed=len(name))
    tblock.load_state_dict(inception_from_flax(variables, tblock))
    x = np.random.RandomState(7).normal(0, 1, (2, hw, hw, cin)).astype(np.float32)
    ref = np.asarray(jblock.apply(variables, x))
    np.testing.assert_allclose(_nchw_block(tblock, x), ref, rtol=TOL, atol=TOL)


@pytest.fixture(scope="module")
def full():
    """(JAX InceptionV3 with a 10-way fc, its random variables, the port's)."""
    jnet = J.InceptionV3(fid_variant=True, num_logits=10)
    variables = _random_variables(jnet, (1, 80, 80, 3), seed=3)
    tnet = T.InceptionV3(num_logits=10).eval()
    tnet.load_state_dict(inception_from_flax(variables, tnet))
    return jnet, variables, tnet


def test_inception_v3_full_width_matches_jax(full):
    """Stem, both stem max pools, every block, pool3 and the fc head at B=2,
    80 px (the whole trunk: Mixed_7c sees 1×1)."""
    jnet, variables, tnet = full
    x = np.random.RandomState(42).uniform(-1, 1, (2, 80, 80, 3)).astype(np.float32)
    j_feats, j_logits = jax.jit(jnet.apply)(variables, x)
    with torch.no_grad():
        feats, logits = tnet(torch.from_numpy(x))
    assert tuple(feats.shape) == (2, T.INCEPTION_FEATURE_DIM) and tuple(logits.shape) == (2, 10)
    np.testing.assert_allclose(feats.numpy(), np.asarray(j_feats), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(logits.numpy(), np.asarray(j_logits), rtol=TOL, atol=TOL)
    assert float(feats.std()) > 0.1


def test_carrier_round_trips_both_collections(full):
    _j, variables, tnet = full
    back = inception_to_flax(tnet.state_dict())
    assert jax.tree.structure(back) == jax.tree.structure(variables)
    for (path, a), (_p, b) in zip(jax.tree_util.tree_leaves_with_path(back),
                                  jax.tree_util.tree_leaves_with_path(variables)):
        np.testing.assert_array_equal(a, b, err_msg=jax.tree_util.keystr(path))
    sd = tnet.state_dict()
    assert {"Conv2d_1a_3x3.conv.weight", "Mixed_5b.branch5x5_1.bn.running_var", "fc.weight"} <= set(sd)


@pytest.mark.parametrize("case", ["uint8_32", "unit_320_grey", "float255_32", "grey_uint8_32"])
def test_preprocess_matches_jax(case):
    rng = np.random.default_rng(len(case))
    if case == "uint8_32":
        x, tol = rng.integers(0, 256, (2, 32, 32, 3)).astype(np.uint8), 1e-5
    elif case == "unit_320_grey":
        x, tol = rng.uniform(0, 1, (2, 320, 320, 1)).astype(np.float32), 3e-5
    elif case == "float255_32":
        x, tol = rng.uniform(0, 255, (2, 32, 32, 3)).astype(np.float32), 1e-5
    else:
        x, tol = rng.integers(0, 256, (2, 32, 32, 1)).astype(np.uint8), 1e-5
    ref = np.asarray(J.InceptionV3.preprocess(x))
    ours = T.InceptionV3.preprocess(x).numpy()
    assert ours.shape == ref.shape == (2, 299, 299, 3) and ours.dtype == np.float32
    np.testing.assert_allclose(ours, ref, rtol=0, atol=tol)
    assert ours.min() >= -1.0 - 1e-6 and ours.max() <= 1.0 + 1e-6


def _torchvision_dict(tnet, seed=0):
    """A torchvision-named ``state_dict``: the extractor's, plus the entries
    a torchvision checkpoint carries that it drops."""
    sd = {k: v.clone() for k, v in tnet.state_dict().items()}
    g = torch.Generator().manual_seed(seed)
    for k in list(sd):
        if k.endswith("bn.running_var"):
            sd[k.replace("running_var", "num_batches_tracked")] = torch.tensor(7)
    sd["AuxLogits.conv0.conv.weight"] = torch.randn(128, 768, 1, 1, generator=g)
    sd["AuxLogits.fc.weight"] = torch.randn(1000, 768, generator=g)
    return sd


def test_load_inception_state_dict_from_pt_and_npz(full, tmp_path):
    _j, variables, tnet = full
    sd = _torchvision_dict(tnet)
    torch.save({"state_dict": sd}, tmp_path / "inception.pth")
    np.savez(tmp_path / "inception.npz", **{k: v.numpy() for k, v in sd.items()})
    expect_trunk = {k for k in tnet.state_dict() if not k.startswith("fc.")}
    for name in ("inception.pth", "inception.npz"):
        trunk = T.load_inception_state_dict(str(tmp_path / name))
        with_fc = T.load_inception_state_dict(str(tmp_path / name), keep_fc=True)
        assert set(trunk) == expect_trunk and set(with_fc) == set(tnet.state_dict())
        assert all(torch.equal(with_fc[k], v) for k, v in tnet.state_dict().items())
        # the JAX loader reads the same file to the same variables
        jv = J.load_inception_variables(str(tmp_path / name), keep_fc=True)
        back = inception_to_flax(with_fc)
        for (path, a), (_p, b) in zip(jax.tree_util.tree_leaves_with_path(back),
                                      jax.tree_util.tree_leaves_with_path(jv)):
            np.testing.assert_array_equal(a, np.asarray(b), err_msg=jax.tree_util.keystr(path))


def test_load_inception_state_dict_refusals(tmp_path):
    with pytest.raises(FileNotFoundError, match="Inception weights not found"):
        T.load_inception_state_dict(str(tmp_path / "missing.pth"))
    for bad, msg in (({"Mixed_5b.branch1x1.bn.momentum": torch.zeros(1)}, "Unrecognized BN entry"),
                     ({"Mixed_5b.branch1x1.weird": torch.zeros(1)}, "Unrecognized state_dict entry")):
        torch.save(bad, tmp_path / "bad.pt")
        with pytest.raises(KeyError, match=msg):
            T.load_inception_state_dict(str(tmp_path / "bad.pt"))
        with pytest.raises(KeyError, match=msg):
            J.load_inception_variables(str(tmp_path / "bad.pt"))


def test_feature_fn_flags_logits_and_refusals(full, tmp_path):
    """The flags, the chunking, the refusal without an ``fc`` and the
    logits (inputs resized to 75 px, not 299: the CPU's time)."""
    _j, _v, tnet = full
    t_pre = T.InceptionV3.preprocess
    with mock.patch.object(T.InceptionV3, "preprocess", staticmethod(lambda x: t_pre(x, size=75))):
        _feature_fn_checks(tnet, tmp_path)


def _feature_fn_checks(tnet, tmp_path):
    images = np.random.default_rng(1).integers(0, 256, (3, 32, 32, 3)).astype(np.uint8)
    fn = T.inception_feature_fn(batch_size=2, device="cpu")
    assert (fn.using_random_weights, fn.feature_dim, fn.num_logits) == (True, 2048, 0)
    feats = fn(images)
    assert feats.shape == (3, 2048) and feats.dtype == np.float32 and feats.std() > 0
    again = T.inception_feature_fn(batch_size=3, device="cpu")(images)
    np.testing.assert_allclose(again, feats, rtol=1e-5, atol=1e-6)  # seeded; chunks of 2 and 3 agree
    sd = {k: v for k, v in _torchvision_dict(tnet).items() if not k.startswith("fc.")}
    torch.save(sd, tmp_path / "trunk.pt")
    with pytest.raises(ValueError, match="has no fc head"):
        T.inception_feature_fn(str(tmp_path / "trunk.pt"), with_logits=True, device="cpu")
    trunk_fn = T.inception_feature_fn(str(tmp_path / "trunk.pt"), batch_size=2, device="cpu")
    assert (trunk_fn.using_random_weights, trunk_fn.num_logits) == (False, 0)
    torch.save(_torchvision_dict(tnet), tmp_path / "fc.pt")
    fc_fn = T.inception_feature_fn(str(tmp_path / "fc.pt"), batch_size=2, with_logits=True, device="cpu")
    f2, probs = fc_fn(images)
    assert fc_fn.num_logits == 10 and probs.shape == (3, 10)
    np.testing.assert_allclose(probs.sum(axis=1), 1.0, rtol=1e-5)
    np.testing.assert_allclose(f2, trunk_fn(images), rtol=1e-5, atol=1e-6)


def test_random_weights_differ_from_jax_unless_carried():
    """The kept property: the two packages' seeded random extractors give
    different features (their PRNG streams differ); the JAX package's
    random init (flax's, conv kernels ×√2), carried into the port's
    network, gives the JAX features. flax draws a parameter from its
    module path, not from the dummy input, so the JAX init runs at 75 px
    (jitted), and both extractors take 75-px inputs."""
    images = np.random.default_rng(2).integers(0, 256, (2, 32, 32, 3)).astype(np.uint8)
    orig_init, j_pre, t_pre = J.InceptionV3.init, J.InceptionV3.preprocess, T.InceptionV3.preprocess

    def small_init(self, key, x):  # jitted: one compile instead of op-by-op dispatch (the same values)
        return jax.jit(lambda k: orig_init(self, k, jnp.zeros((1, 75, 75, 3))))(key)

    # Both extractors resize to 75 px here (the trunk's least input), not 299: the CPU's time.
    with mock.patch.object(J.InceptionV3, "init", small_init), \
            mock.patch.object(J.InceptionV3, "preprocess", staticmethod(lambda x: j_pre(x, size=75))), \
            mock.patch.object(T.InceptionV3, "preprocess", staticmethod(lambda x: t_pre(x, size=75))):
        jfn = J.inception_feature_fn(None, batch_size=2)
        ref = jfn(images)
        ours = T.inception_feature_fn(batch_size=2, device="cpu")
        mine = ours(images)
        jvars = dict(zip(jfn.__code__.co_freevars, (c.cell_contents for c in jfn.__closure__)))["variables"]
        ours.net.load_state_dict(inception_from_flax(jax.tree.map(np.asarray, jvars), ours.net))
        carried = ours(images)
    assert ours.using_random_weights and jfn.using_random_weights
    assert np.linalg.norm(mine - ref) > 0.1 * np.linalg.norm(ref)
    assert np.linalg.norm(carried - ref) <= TOL * np.linalg.norm(ref)


@pytest.mark.parametrize("extractor", ["pixels", "inception"])
def test_compute_fid_cli_prints_jax_lines(tmp_path, extractor):
    """``cli/compute_fid.py`` on a tiny DDPM archive (8 px, DDIM-2), 2
    samples against 2 synthetic images: JAX's line format, the random
    weights labelled; KID and (inception) IS too; a second run (pixels)
    repeats every line."""
    from diffusion_model_nemo_tpu_torch.cli import compute_fid

    cfg = unet_small_model_config(image_size=8)
    cfg["diffusion_model"].update(dim=8, dim_mults=[1, 2], resnet_block_groups=4, input_dim=8, dtype="float32")
    path = DDPM(cfg, device="cpu", seed=0).save_to(str(tmp_path / "tiny.dmn"))
    argv = [f"model_path={path}", "dataset_name=synthetic", "num_samples=2", "batch_size=2", "ddim_timesteps=2",
            f"feature_extractor={extractor}", "compute_kid=true", "device=cpu"]
    if extractor == "inception":
        argv += ["compute_is=true", "is_splits=2"]
    runs = []
    for _ in range(2 if extractor == "pixels" else 1):
        buf = io.StringIO()
        with redirect_stdout(buf):
            result = compute_fid.main(argv)
        runs.append((buf.getvalue(), result))
    out, result = runs[0]
    label = ("InceptionV3-pool3 with RANDOM weights (relative metric only)" if extractor == "inception"
             else "pixel moments (relative metric only)")
    assert re.search(rf"^FID: -?\d+\.\d{{4}} \[{re.escape(label)}\]$", out, re.M), out
    assert re.search(rf"^KID: -?\d+\.\d{{6}} \+/- \d+\.\d{{6}} \[{re.escape(label)}\]$", out, re.M), out
    if extractor == "inception":
        assert re.search(rf"^IS: \d+\.\d{{4}} \+/- \d+\.\d{{4}} \[{re.escape(label)}\]$", out, re.M), out
    assert np.isfinite(result["fid"]) and runs[-1][0] == out
    with pytest.raises(ValueError, match="compute_is requires"):
        compute_fid.main([f"model_path={path}", "feature_extractor=pixels", "compute_is=true", "device=cpu",
                          "dataset_name=synthetic"])


def test_new_modules_load_neither_jax_nor_the_jax_package():
    """In a fresh interpreter (this one has JAX loaded by conftest): the
    extractor, LoRA, the MoE DiT and their CLIs import no JAX, flax or
    JAX-package module."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    code = (
        "import sys\n"
        "import diffusion_model_nemo_tpu_torch.metrics.inception, diffusion_model_nemo_tpu_torch.training.lora\n"
        "import diffusion_model_nemo_tpu_torch.modules.dit, diffusion_model_nemo_tpu_torch.cli.compute_fid\n"
        "import diffusion_model_nemo_tpu_torch.cli.finetune_lora\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'diffusion_model_nemo_tpu'))\n"
        "assert not bad, bad\n"
    )
    repo = Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(repo), OMP_NUM_THREADS="1")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=repo, env=env, timeout=120)
