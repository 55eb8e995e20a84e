"""The port's offline file datasets against the JAX package's on the CPU.

What is held:
- ``FileVisionDataset`` item for item against JAX's: npz in NCHW uint8
  with labels, npz floats in [0, 1] and [-1, 1], npy grey [N, H, W], and
  PNG folders with ``labels.npy`` (Pillow-written PNGs in modes L, LA, RGB,
  RGBA and P at 1, 2, 4 and 8 bits, filters 0-4, each converted as
  ``Image.convert("RGB")``, which JAX's dataset calls) and a BMP read
  through Pillow;
- ``decode_png`` against Pillow for every filter type, and its refusals
  (16-bit, interlaced);
- ``resize_to``: the port's Pillow-compatible BILINEAR resize equal to
  Pillow byte for byte (grey, grey + alpha, RGB, RGBA; shrinking,
  enlarging, one axis), and the loader's batches equal to JAX's;
- ``num_workers`` 0 and 2 give identical batches over two shuffled epochs;
- ``build_dataloader``'s refusals (``caption_len``, a Hugging Face name,
  a missing path, an empty folder, a short ``labels.npy``);
- an image directory as ``input_path`` of ``inpaint_ddpm`` and
  ``edit_ddpm``.
"""

import io
import struct
import zlib
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from diffusion_model_nemo_tpu.data.hf_vision_data import DataLoader as JDataLoader
from diffusion_model_nemo_tpu.data.hf_vision_data import FileVisionDataset as JFileVisionDataset
from diffusion_model_nemo_tpu_torch.cli import edit_ddpm, inpaint_ddpm
from diffusion_model_nemo_tpu_torch.config import load_config
from diffusion_model_nemo_tpu_torch.data import DataLoader, FileVisionDataset, build_dataloader
from diffusion_model_nemo_tpu_torch.models import DDPM
from diffusion_model_nemo_tpu_torch.utils.image import decode_png, encode_png, make_grid, resize_bilinear_uint8

REPO = Path(__file__).resolve().parents[1]
RNG = np.random.default_rng(0)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _png(array: np.ndarray, mode: str, optimize: bool = True, palette=None) -> bytes:
    img = Image.fromarray(array, mode)
    if palette is not None:
        img.putpalette(palette)
    buf = io.BytesIO()
    img.save(buf, "PNG", optimize=optimize)
    return buf.getvalue()


def _filters(png: bytes) -> set:
    """The filter types of a PNG's scanlines."""
    pos, idat, header = 8, b"", None
    while pos < len(png):
        (n,) = struct.unpack(">I", png[pos: pos + 4])
        kind, body = png[pos + 4: pos + 8], png[pos + 8: pos + 8 + n]
        header = struct.unpack(">IIBBBBB", body) if kind == b"IHDR" else header
        idat += body if kind == b"IDAT" else b""
        pos += 12 + n
    w, h, depth, color = header[:4]
    stride = -(-w * {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[color] * depth // 8)
    raw = zlib.decompress(idat)
    return {raw[y * (stride + 1)] for y in range(h)}


def _pillow_pngs(size=12):
    """Noise images that Pillow writes with every filter type: (name, PNG
    bytes) in modes L, LA, RGB, RGBA, and P with 2, 4, 16 and 200 colours
    (1, 2, 4 and 8 bits a pixel)."""
    out = []
    for mode, ch in (("L", 1), ("LA", 2), ("RGB", 3), ("RGBA", 4)):
        a = RNG.integers(0, 256, (size, size, ch), dtype=np.uint8)
        out.append((mode, _png(a[..., 0] if ch == 1 else a, mode)))
    for colours in (2, 4, 16, 200):
        idx = RNG.integers(0, colours, (size, size), dtype=np.uint8)
        pal = RNG.integers(0, 256, colours * 3).astype(np.uint8).tolist()
        out.append((f"P{colours}", _png(idx, "P", palette=pal)))
    return out


def test_decode_png_reads_what_pillow_writes_and_refuses_the_rest():
    seen = set()
    for name, data in _pillow_pngs():
        seen |= _filters(data)
        ref = np.asarray(Image.open(io.BytesIO(data)))
        ref = ref if not name.startswith("P") else np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
        assert np.array_equal(decode_png(data), ref.reshape(decode_png(data).shape)), name
    assert seen == {0, 1, 2, 3, 4}
    grey1 = _png((RNG.integers(0, 2, (9, 9)) * 255).astype(np.uint8), "L")
    one_bit = io.BytesIO()
    Image.open(io.BytesIO(grey1)).convert("1").save(one_bit, "PNG")
    ref = np.asarray(Image.open(io.BytesIO(one_bit.getvalue())).convert("L"))
    assert np.array_equal(decode_png(one_bit.getvalue())[..., 0], ref)
    sixteen = io.BytesIO()
    Image.fromarray(RNG.integers(0, 65535, (4, 4)).astype(np.uint16)).save(sixteen, "PNG")
    with pytest.raises(ValueError, match="16-bit"):
        decode_png(sixteen.getvalue())
    plain = encode_png(RNG.integers(0, 256, (4, 4, 3), dtype=np.uint8))
    ihdr = plain[16:29]
    laced = ihdr[:-1] + b"\x01"
    patched = plain[:16] + laced + struct.pack(">I", zlib.crc32(b"IHDR" + laced)) + plain[33:]
    with pytest.raises(ValueError, match="interlaced"):
        decode_png(patched)
    with pytest.raises(ValueError, match="CRC"):
        decode_png(plain[:16] + laced + plain[29:])


def _folder(tmp_path: Path) -> Path:
    d = tmp_path / "pngs"
    d.mkdir()
    for i, (name, data) in enumerate(_pillow_pngs()):
        (d / f"{i:02d}_{name}.png").write_bytes(data)
    Image.fromarray(RNG.integers(0, 256, (12, 12, 3), dtype=np.uint8)).save(d / "99_rgb.bmp")
    (d / "notes.txt").write_text("not an image")
    np.save(d / "labels.npy", np.arange(9) % 4)
    return d


def _items(ds):
    return [ds[i] for i in range(len(ds))]


def _assert_items_equal(ours, ref):
    assert len(ours) == len(ref)
    for a, b in zip(ours, ref):
        assert set(a) == set(b)
        for k in a:
            assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype and np.array_equal(a[k], b[k]), k


@pytest.mark.parametrize("layout", ["npz-nchw-labels", "npz-unit-float", "npz-signed-float", "npy-grey", "png-folder"])
def test_file_dataset_matches_jax(layout, tmp_path):
    if layout == "png-folder":
        path = _folder(tmp_path)
    else:
        x = RNG.integers(0, 256, (5, 3, 8, 8), dtype=np.uint8)
        arrays = {"npz-nchw-labels": dict(images=x, labels=np.arange(5).astype(np.int64)),
                  "npz-unit-float": dict(images=x.transpose(0, 2, 3, 1) / 255.0),
                  "npz-signed-float": dict(images=(x.transpose(0, 2, 3, 1) / 127.5 - 1.0).astype(np.float32))}
        if layout == "npy-grey":
            path = tmp_path / "x.npy"
            np.save(path, x[:, 0])
        else:
            path = tmp_path / "x.npz"
            np.savez(path, **arrays[layout])
    ours, ref = FileVisionDataset(str(path)), JFileVisionDataset(str(path))
    _assert_items_equal(_items(ours), _items(ref))
    assert ours[0]["image"].dtype == np.uint8 and ours[0]["image"].ndim == 3


@pytest.mark.parametrize("channels,mode", [(1, "L"), (2, "LA"), (3, "RGB"), (4, "RGBA")])
def test_resize_bilinear_equals_pillow_byte_for_byte(channels, mode):
    for h, w, size in ((32, 32, 8), (17, 23, 7), (8, 8, 16), (5, 9, 13), (12, 30, 12), (40, 40, 40)):
        a = RNG.integers(0, 256, (h, w, channels), dtype=np.uint8)
        ref = np.asarray(Image.fromarray(a[..., 0] if channels == 1 else a, mode).resize((size, size),
                                                                                         Image.BILINEAR))
        assert np.array_equal(resize_bilinear_uint8(a, size), ref.reshape(size, size, channels)), (h, w, size)


def test_loader_resize_to_matches_jax(tmp_path):
    """``resize_to`` through both loaders (an item whose height already
    matches is left alone, the JAX loader's rule; a 2-channel array is
    Pillow's LA)."""
    for i, shape in enumerate(((6, 20, 20, 3), (6, 10, 10, 1), (6, 16, 9, 4), (6, 12, 12, 2))):
        np.savez(tmp_path / f"{i}.npz", images=RNG.integers(0, 256, shape, dtype=np.uint8))
        for size in (16, 24):
            ours = build_dataloader({"name": "file", "path": str(tmp_path / f"{i}.npz"), "batch_size": 3,
                                     "shuffle": False, "resize_to": size}, mode="test")
            ref = JDataLoader(JFileVisionDataset(str(tmp_path / f"{i}.npz")), batch_size=3, image_size=size)
            for a, b in zip(ours, ref):
                assert np.array_equal(a["image"], b["image"]), (shape, size)


def test_num_workers_give_the_serial_batches(tmp_path):
    d = _folder(tmp_path)
    loaders = [DataLoader(FileVisionDataset(str(d)), batch_size=4, shuffle=True, seed=3, image_size=10,
                          num_workers=n) for n in (0, 2)]
    ref = JDataLoader(JFileVisionDataset(str(d)), batch_size=4, shuffle=True, seed=3, image_size=10, num_workers=2)
    for _epoch in range(2):
        batches = [list(dl) for dl in loaders] + [list(ref)]
        assert len(batches[0]) == 2
        for a, b, c in zip(*batches):
            assert all(np.array_equal(a[k], b[k]) and np.array_equal(a[k], c[k]) for k in a)


def test_build_dataloader_refusals(tmp_path):
    with pytest.raises(NotImplementedError, match="text-conditioning"):
        build_dataloader({"name": "synthetic", "caption_len": 16}, mode="train")
    with pytest.raises(NotImplementedError, match="download"):
        build_dataloader({"name": "cifar10"}, mode="train")
    with pytest.raises(FileNotFoundError):
        build_dataloader({"name": "file", "path": str(tmp_path / "nope.npz")}, mode="train")
    (tmp_path / "empty").mkdir()
    with pytest.raises(ValueError, match="No image files"):
        FileVisionDataset(str(tmp_path / "empty"))
    d = _folder(tmp_path)
    np.save(d / "labels.npy", np.arange(3))
    with pytest.raises(ValueError, match="labels.npy has 3 entries for 9"):
        FileVisionDataset(str(d))
    np.savez(tmp_path / "k.npz", pixels=np.zeros((2, 4, 4, 3), np.uint8))
    with pytest.raises(KeyError, match="image_key"):
        FileVisionDataset(str(tmp_path / "k.npz"))
    with pytest.raises(ValueError, match="Unsupported"):
        (tmp_path / "x.csv").write_text("1")
        FileVisionDataset(str(tmp_path / "x.csv"))


def test_edit_and_inpaint_read_an_image_directory(tmp_path):
    """The CLIs' ``input_path`` as a folder of PNGs at the model's size:
    each CLI's ``input.png`` grid is the folder's images, in name order."""
    cfg = load_config(REPO / "examples/configs/ddpm/unet_small.yaml", overrides=[
        "model.image_size=8", "model.timesteps=4", "model.diffusion_model.dim=8",
        "model.diffusion_model.dim_mults=[1,2]", "model.diffusion_model.dtype=float32"]).model
    dmn = DDPM(cfg, device="cpu").save_to(str(tmp_path / "m.dmn"))
    imgs = RNG.integers(0, 256, (3, 8, 8, 3), dtype=np.uint8)
    folder = tmp_path / "in"
    folder.mkdir()
    for i, img in enumerate(imgs):
        (folder / f"{i}.png").write_bytes(_png(img, "RGB"))
    common = [f"model_path={dmn}", f"input_path={folder}", "batch_size=8", "device=cpu", "add_timestamp=false"]
    for cli, extra in ((edit_ddpm, ["strength=0.5"]), (inpaint_ddpm, ["jump_length=1", "jump_n_sample=1"])):
        out = cli.main([*common, f"output_dir={tmp_path / cli.__name__}", *extra])
        assert np.array_equal(decode_png((out / "input.png").read_bytes()), make_grid(imgs / 255.0, nrow=6))
        assert len(list(out.glob("*_[0-9].png"))) == 3
    with pytest.raises(ValueError, match="images must be \\[N, 8, 8, 3\\]"):
        small = tmp_path / "small"
        small.mkdir()
        (small / "a.png").write_bytes(_png(imgs[0, :4, :4], "RGB"))
        edit_ddpm.main([f"model_path={dmn}", f"input_path={small}", "device=cpu", f"output_dir={tmp_path / 'x'}"])
