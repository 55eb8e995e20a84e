"""The port's YAML reader and writer and its config layer against PyYAML
and the JAX package's ``config/yaml_config.py``, on the CPU.

The port reads YAML with its own standard-library reader (the GPU machine
has no PyYAML); the CPU test environment has PyYAML, so every config under
``examples/configs/`` is loaded by both and compared, with and without
overrides, and each package's ``to_yaml`` is read back by the other reader.
"""

from pathlib import Path

import pytest
import torch
import yaml

from diffusion_model_nemo_tpu.config import yaml_config as J
from diffusion_model_nemo_tpu_torch.config import (
    YAMLError,
    dit_small_model_config,
    instantiate,
    load_config,
    parse_value,
    parse_yaml,
    to_dict,
    to_yaml,
    unet_small_model_config,
)

REPO = Path(__file__).resolve().parents[1]
CONFIGS = sorted((REPO / "examples" / "configs").rglob("*.yaml"))
IDS = [str(p.relative_to(REPO / "examples" / "configs")) for p in CONFIGS]
# A dotted key, a new key, a list literal, null and 1e-5 (a float only under
# the JAX loader's float-safe resolver), a flow map and a quoted string.
OVERRIDES = [
    "name=renamed",
    "+new.key=1",
    "+model.lst=[1, 2, 'a', null]",
    "+model.nothing=null",
    "+model.eps=1e-5",
    "+model.fm={a: 1, b: [x, y]}",
    "+model.q='1.0'",
    "model.channels=1",
]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_every_config_file_is_covered():
    assert len(CONFIGS) == 13


@pytest.mark.parametrize("overrides", [False, True], ids=["plain", "overrides"])
@pytest.mark.parametrize("path", CONFIGS, ids=IDS)
def test_config_loads_like_the_jax_loader(path, overrides):
    ovs = OVERRIDES if overrides else None
    ours = to_dict(load_config(path, overrides=ovs))
    ref = J.to_dict(J.load_config(path, overrides=ovs))
    assert ours == ref
    assert type(ours["model"]) is dict and ours == to_dict(ours)
    if overrides:
        assert ours["model"]["eps"] == 1e-5 and ours["model"]["q"] == "1.0"


@pytest.mark.parametrize("path", CONFIGS, ids=IDS)
def test_to_yaml_round_trips_under_both_readers(path):
    cfg = to_dict(load_config(path, resolve=False))
    text = to_yaml(cfg)
    assert parse_yaml(text) == cfg
    assert J._yaml_load(text) == cfg  # PyYAML with the float-safe resolver
    assert yaml.safe_load(text) == cfg  # what the JAX load_archive uses


@pytest.mark.parametrize("path", CONFIGS, ids=IDS)
def test_jax_to_yaml_reads_in_the_port(path):
    cfg = J.load_config(path, resolve=False)
    assert parse_yaml(J.to_yaml(cfg)) == J.to_dict(cfg)


def test_safe_dump_forms_read_back():
    data = {
        "a": "???", "b": "${model.x}", "c": 1e-5, "d": 0.0001, "e": [1, 2, [3, 4]], "f": {}, "g": [],
        "h": {"x": 1, "y": "it's"}, "i": "1.0", "j": None, "k": True, "l": "yes", "m": "",
        "n": "a: b", "o": [{"p": 1, "q": 2}, {"z": [1, {"w": 3}]}], "r": float("inf"), "s": "null",
        "v": "#c", "w": "-x", "z": 3.0, "bb": 12345678901234567890, "cc": "héllo", "dd": -0.5,
        3: "int key", "tab": "a\tb",
    }
    dumped = yaml.safe_dump(data, sort_keys=False, default_flow_style=None)
    assert parse_yaml(dumped) == data
    assert parse_yaml(yaml.safe_dump(data, sort_keys=False, default_flow_style=False)) == data
    ours = to_yaml(data)
    assert parse_yaml(ours) == data and yaml.safe_load(ours) == data and J._yaml_load(ours) == data


def test_flow_collections_across_lines():
    data = {"long": list(range(60)), "m": {f"key_{i}": i * 0.5 for i in range(12)}}
    dumped = yaml.safe_dump(data, default_flow_style=None, width=40)
    assert dumped.count("\n") > 4  # the flow collections wrapped
    assert parse_yaml(dumped) == data


@pytest.mark.parametrize(
    "text,what",
    [
        ("a: &anchor 1\nb: *anchor\n", "anchors"),
        ("a: 1\nb: *x\n", "aliases"),
        ("a: !!python/tuple [1, 2]\n", "tags"),
        ("a: |\n  block\n", "block scalars"),
        ("a: first line\n  second line\n", "multi-line"),
        ("a: 'open\n  close'\n", "multi-line"),
        ("a: yes\n", "YAML 1.1"),
        ("a: 0x1F\n", "YAML 1.1"),
        ("a: 1_000\n", "YAML 1.1"),
        ("a: 2024-01-01\n", "YAML 1.1"),
        ("a: 1\n---\nb: 2\n", "one document"),
        ("? complex\n: key\n", "complex keys"),
        ("a: b: c\n", "mapping is not allowed"),
    ],
)
def test_unknown_syntax_raises_naming_the_line(text, what):
    with pytest.raises(YAMLError, match=what) as err:
        parse_yaml(text, name="cfg.yaml")
    line = 2 if text.startswith("a: 1\n") or "second" in text else 1
    assert f"cfg.yaml:{line}:" in str(err.value)


def test_override_values_parse_as_yaml_scalars():
    assert parse_value("[1,2]") == [1, 2]
    assert parse_value("null") is None and parse_value("") is None
    assert parse_value("1e-5") == 1e-5 and parse_value("3") == 3 and parse_value("-0.5") == -0.5
    assert parse_value("true") is True and parse_value("abc") == "abc" and parse_value("'x y'") == "x y"
    assert parse_value("${a.b}") == "${a.b}"
    with pytest.raises(YAMLError, match="mapping is not allowed"):
        parse_value("a: b")  # PyYAML reads a mapping: refused, not read as a string


def test_overrides_refuse_unknown_keys_without_plus():
    path = REPO / "examples/configs/ddpm/unet_small.yaml"
    with pytest.raises(KeyError, match=r"\+model.nope"):
        load_config(path, overrides=["model.nope=1"])


@pytest.mark.parametrize(
    "path,image_size,build",
    [
        ("examples/configs/ddpm/unet_small.yaml", 32, unet_small_model_config),
        ("examples/configs/dit/dit_small.yaml", 64, dit_small_model_config),
    ],
    ids=["unet_small", "dit_small"],
)
def test_hand_copied_configs_match_their_yaml(path, image_size, build):
    """``config/unet_small.py`` and ``config/dit_small.py`` are the YAML's
    model block at their image size, key for key: no key differs on
    purpose (one that ever does is popped from both sides here, with its
    reason)."""
    model = to_dict(load_config(REPO / path, overrides=[f"model.image_size={image_size}"]).model)
    assert build() == model


def test_instantiate_builds_a_loaded_model_config():
    cfg = load_config(REPO / "examples/configs/ddpm/unet_small.yaml", overrides=[
        "model.image_size=8", "model.timesteps=10", "model.diffusion_model.dim=8",
        "model.diffusion_model.dim_mults=[1,2]",
    ])
    model = instantiate({"_target_": "diffusion_model_nemo.models.DDPM"}, cfg.model, device="cpu")
    assert type(model).__name__ == "DDPM" and model.sampler.timesteps == 10
    assert model.cfg.diffusion_model.dim == 8 and model.params["init_conv.weight"].shape[0] == 8
