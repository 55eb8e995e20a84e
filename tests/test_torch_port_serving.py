"""The PyTorch port's sampling server on the CPU: HTTP routes, seeded
determinism, request coalescing (by label and guidance scale on a
ConditionalDDPM), the 400 answers, and the standard-library PNG codec
that replaces the JAX package's Pillow dependency."""

import base64
import io
import json
import threading
import time
import urllib.error
import urllib.request
import zlib

import numpy as np
import pytest
import torch

from diffusion_model_nemo_tpu.utils.image import to_uint8 as jax_pkg_to_uint8
from diffusion_model_nemo_tpu_torch.config import unet_small_model_config
from diffusion_model_nemo_tpu_torch.models import DDPM, ConditionalDDPM
from diffusion_model_nemo_tpu_torch.serving import BatchingSampler, SamplingServer, serve
from diffusion_model_nemo_tpu_torch.utils.image import (
    decode_png,
    encode_png,
    to_uint8,
    to_uint8_tensor,
)

IMG = 8
MAX_BATCH = 4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _tiny_model():
    cfg = unet_small_model_config(image_size=IMG, timesteps=10)
    cfg["diffusion_model"].update(dim=16, dim_mults=[1, 2])
    cfg["sampler"]["timesteps"] = 10
    return DDPM(cfg, device="cpu", seed=0)


@pytest.fixture(scope="module")
def server():
    srv = serve(_tiny_model(), port=0, max_batch=MAX_BATCH, ddim_timesteps=2)
    srv.start_background()
    yield srv
    srv.shutdown()


def _call(srv, method, path, payload=None, raw=None):
    data = raw if raw is not None else (None if payload is None else json.dumps(payload).encode())
    req = urllib.request.Request(f"http://{srv.host}:{srv.port}{path}", data=data, method=method)
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def test_healthz_and_stats(server):
    code, body = _call(server, "GET", "/healthz")
    assert code == 200 and json.loads(body) == {"status": "ok", "warm": True, "mode": "sample"}
    code, body = _call(server, "GET", "/stats")
    stats = json.loads(body)
    assert code == 200 and stats["max_batch"] == MAX_BATCH
    assert {"requests", "images", "batches", "avg_batch_fill"} <= set(stats)


def test_sample_png_and_npy(server):
    code, body = _call(server, "POST", "/sample", {"num_images": 2, "format": "png"})
    assert code == 200
    images = [decode_png(base64.b64decode(s)) for s in json.loads(body)["images"]]
    assert len(images) == 2 and all(im.shape == (IMG, IMG, 3) for im in images)
    code, body = _call(server, "POST", "/sample", {"num_images": 3, "format": "npy"})
    arr = np.load(io.BytesIO(body))
    assert code == 200 and arr.shape == (3, IMG, IMG, 3) and arr.dtype == np.uint8


def test_seeded_requests_repeat_bit_for_bit(server):
    def sample(seed):
        code, body = _call(server, "POST", "/sample", {"num_images": 2, "seed": seed, "format": "npy"})
        assert code == 200
        return np.load(io.BytesIO(body))

    a, b, c = sample(11), sample(11), sample(12)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)


def test_large_request_is_chunked(server):
    code, body = _call(server, "POST", "/sample", {"num_images": MAX_BATCH + 2, "format": "npy"})
    assert code == 200 and np.load(io.BytesIO(body)).shape == (MAX_BATCH + 2, IMG, IMG, 3)


@pytest.mark.parametrize(
    "payload,raw",
    [
        ({"num_images": 0}, None),
        ({"num_images": "many"}, None),
        ({"num_images": 1, "format": "gif"}, None),
        ({"num_images": 1, "label": 3}, None),  # a label to an unconditional archive
        ({"num_images": 1, "seed": "abc"}, None),
        (None, b"{not json"),
        (None, b"[1, 2]"),
    ],
)
def test_bad_payload_is_a_400(server, payload, raw):
    code, body = _call(server, "POST", "/sample", payload, raw=raw)
    assert code == 400, body
    assert "error" in json.loads(body)


def _tiny_conditional_model():
    cfg = unet_small_model_config(image_size=IMG, timesteps=10)
    cfg["diffusion_model"].update(dim=16, dim_mults=[1, 2], num_classes=10)
    cfg["sampler"].update(timesteps=10, class_conditional=True)
    cfg["num_classes"] = 10
    return ConditionalDDPM(cfg, device="cpu", seed=0)


@pytest.fixture(scope="module")
def conditional_server():
    srv = serve(_tiny_conditional_model(), port=0, max_batch=MAX_BATCH, ddim_timesteps=2)
    srv.start_background()
    yield srv
    srv.shutdown()


@pytest.mark.parametrize("payload", [{"label": 10}, {"label": -1}, {"guidance_scale": 2.0},
                                     {"label": 2, "guidance_scale": "strong"}],
                         ids=["label-past-K", "negative-label", "guidance-without-label", "bad-guidance"])
def test_conditional_bad_labels_are_a_400(conditional_server, payload):
    code, body = _call(conditional_server, "POST", "/sample", dict(payload, num_images=1))
    assert code == 400 and "error" in json.loads(body), body


def test_conditional_seeded_guided_request_is_the_models_chain(conditional_server):
    """A seeded guided request repeats bit for bit and equals
    ``ConditionalDDPM.sample`` with the same label, scale and seed."""
    payload = {"num_images": 2, "label": 3, "guidance_scale": 3.0, "seed": 9, "format": "npy"}
    first, again = (np.load(io.BytesIO(_call(conditional_server, "POST", "/sample", payload)[1])) for _ in range(2))
    model = conditional_server.batcher.model
    ref = model.sample(MAX_BATCH, IMG, generator=torch.Generator().manual_seed(9), label=3, guidance_scale=3.0,
                       use_ema=True)
    assert np.array_equal(first, again) and np.array_equal(first, to_uint8_tensor(ref)[:2].numpy())
    plain = np.load(io.BytesIO(_call(conditional_server, "POST", "/sample", dict(payload, guidance_scale=None))[1]))
    assert not np.array_equal(plain, first)


def test_requests_coalesce_by_label_and_guidance_scale():
    """Unseeded requests share a batch only with the same label and scale:
    two label-1 requests go together; label 2, the null class and label 1
    guided each go alone."""
    batcher = BatchingSampler(_tiny_conditional_model(), IMG, max_batch=MAX_BATCH, linger_ms=300.0)
    batcher.start(warmup=False)
    try:
        kinds = [(1, None), (1, None), (2, None), (None, None), (1, 2.0)]
        results = {}
        threads = [threading.Thread(target=lambda i=i, k=k: results.__setitem__(
            i, batcher.submit(1, label=k[0], guidance_scale=k[1], timeout=120))) for i, k in enumerate(kinds)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
        assert sorted(results) == list(range(5)) and all(r.shape == (1, IMG, IMG, 3) for r in results.values())
        stats = batcher.snapshot_stats()
        assert stats["requests"] == 5 and stats["batches"] == 4, stats
    finally:
        batcher.stop()


def test_unported_routes_and_unknown_paths(server):
    assert _call(server, "POST", "/super_resolve", {})[0] == 400  # ported: a DDPM archive is not an SR3
    assert _call(server, "POST", "/edit", {})[0] == 400  # ported: an edit needs images_npy
    assert _call(server, "POST", "/vocode", {})[0] == 400  # ported: a DDPM archive is not a vocoder
    assert _call(server, "POST", "/nope", {})[0] == 404
    assert _call(server, "GET", "/nope")[0] == 404


def test_concurrent_unseeded_requests_coalesce():
    batcher = BatchingSampler(_tiny_model(), IMG, max_batch=MAX_BATCH, linger_ms=300.0)
    batcher.start(warmup=False)
    try:
        results = []
        threads = [
            threading.Thread(target=lambda: results.append(batcher.submit(1, timeout=120)))
            for _ in range(3)
        ]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
        assert not any(th.is_alive() for th in threads)
        assert [r.shape for r in results] == [(1, IMG, IMG, 3)] * 3
        stats = batcher.snapshot_stats()
        assert stats["batches"] == 1 and stats["requests"] == 3 and stats["images"] == 3
        assert stats["avg_batch_fill"] == pytest.approx(3 / MAX_BATCH)
    finally:
        batcher.stop()
    assert not batcher._worker.is_alive()


def test_worker_fault_reaches_the_client_as_an_error():
    model = _tiny_model()
    batcher = BatchingSampler(model, IMG, max_batch=MAX_BATCH, linger_ms=1.0)
    model.sample = lambda **kw: (_ for _ in ()).throw(RuntimeError("device lost"))
    batcher.start(warmup=False)
    try:
        with pytest.raises(RuntimeError, match="device lost"):
            batcher.submit(1, timeout=60)
    finally:
        batcher.stop()


class _FixedTimeModel:
    """A model whose ``sample()`` takes a fixed host time, as the port's
    host-bound sampling chain does."""

    device = "cpu"

    def __init__(self, seconds: float):
        self.seconds = seconds

    def sample(self, batch_size, image_size, generator=None, use_ema=True):
        time.sleep(self.seconds)
        return torch.rand(batch_size, image_size, image_size, 3, generator=generator)


@pytest.mark.parametrize("second_delay_ms", [0, 50])
def test_a_batch_is_answered_when_its_own_chain_ends(second_delay_ms):
    """Two full-batch unseeded requests run as two batches, and the first
    is answered when its own chain ends: at least 0.8 batch times before
    the second, not together with it after both chains. Both submits are
    released by one barrier, the second ``second_delay_ms`` later, and
    every time is read against one common start taken before the barrier,
    so the checks hold whatever the threads' start delays: the second
    answer comes at least two batch times after that start."""
    batch_s = 0.5
    batcher = BatchingSampler(_FixedTimeModel(batch_s), IMG, max_batch=MAX_BATCH, linger_ms=1.0)
    batcher.start(warmup=False)
    try:
        answered, shapes = [], []
        barrier = threading.Barrier(2)

        def request(delay_s):
            barrier.wait(timeout=60)
            time.sleep(delay_s)
            shapes.append(batcher.submit(MAX_BATCH, timeout=60).shape)
            answered.append(time.perf_counter())

        threads = [threading.Thread(target=request, args=(d,)) for d in (0.0, second_delay_ms / 1e3)]
        start = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        assert not any(th.is_alive() for th in threads)
    finally:
        batcher.stop()
    assert shapes == [(MAX_BATCH, IMG, IMG, 3)] * 2
    assert batcher.snapshot_stats()["batches"] == 2
    first, second = sorted(t - start for t in answered)
    assert second - first >= 0.8 * batch_s, (first, second)
    assert second >= 2 * batch_s, (first, second)


def test_uint8_quantization_matches_the_jax_package():
    x = np.linspace(-0.2, 1.2, 101, dtype=np.float32).reshape(1, 101, 1, 1)
    expect = jax_pkg_to_uint8(x)
    np.testing.assert_array_equal(to_uint8(x), expect)
    np.testing.assert_array_equal(to_uint8_tensor(torch.from_numpy(x)).numpy(), expect)


@pytest.mark.parametrize("shape", [(5, 7, 3), (4, 6, 1), (3, 2)])
def test_png_round_trip(shape):
    img = np.random.default_rng(0).integers(0, 256, size=shape, dtype=np.uint8)
    data = encode_png(img)
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    out = decode_png(data)
    np.testing.assert_array_equal(out, img.reshape(out.shape))
    # the IDAT payload is a plain zlib stream of filter-0 rows
    idat = data.index(b"IDAT")
    (length,) = np.frombuffer(data[idat - 4 : idat], ">u4")
    rows = zlib.decompress(data[idat + 4 : idat + 4 + int(length)])
    assert len(rows) == shape[0] * (1 + int(np.prod(shape[1:])))


def test_png_decoder_rejects_corruption():
    data = bytearray(encode_png(np.zeros((2, 2, 3), np.uint8)))
    with pytest.raises(ValueError, match="signature"):
        decode_png(b"GIF89a" + bytes(data[6:]))
    data[-20] ^= 0xFF  # inside IDAT: its CRC no longer holds
    with pytest.raises(ValueError, match="CRC"):
        decode_png(bytes(data))
    with pytest.raises(TypeError):
        encode_png(np.zeros((2, 2, 3), np.float32))


# ------------------------------------------------ fast samplers and /edit --
@pytest.mark.parametrize("flags,expect", [
    ({"use_dpm_solver": True, "dpm_steps": 3}, "DPMSolverDiffusion"),
    ({"use_karras_sampler": True, "karras_steps": 3}, "KarrasDiffusion"),
    ({"use_unipc": True, "unipc_steps": 3}, "UniPCDiffusion"),
    ({"use_unipc": True, "use_karras_sampler": True, "use_dpm_solver": True, "unipc_steps": 3}, "UniPCDiffusion"),
    ({"use_karras_sampler": True, "use_dpm_solver": True, "karras_steps": 3}, "KarrasDiffusion"),
    ({"use_dpm_solver": True, "dpm_steps": 3, "ddim_timesteps": 2}, "DPMSolverDiffusion"),
    ({"ddim_timesteps": 2}, "GeneralizedGaussianDiffusion"),
    ({"use_ddim_sampler": False}, "GaussianDiffusion"),
], ids=["dpm", "karras", "unipc", "unipc>karras>dpm", "karras>dpm", "dpm>ddim", "ddim", "none"])
def test_serve_swaps_samplers_with_the_jax_precedence(flags, expect):
    """``serve``'s sampler flags and their precedence UniPC > Karras >
    DPM-Solver++ > DDIM (the JAX server's); the warm-up batch and a seeded
    request run on the swapped sampler."""
    srv = serve(_tiny_model(), port=0, max_batch=MAX_BATCH, **flags)
    try:
        assert type(srv.batcher.model.sampler).__name__ == expect
        out = srv.batcher.submit(2, seed=1, timeout=120)
        assert out.shape == (2, IMG, IMG, 3) and out.dtype == np.uint8
    finally:
        srv.shutdown()


def test_serve_refuses_the_swaps_for_an_archive_without_a_schedule():
    class NoSchedule:  # a ScoreSDE's sampler has no discrete table
        pass

    model = _tiny_model()
    model.sampler = NoSchedule()
    with pytest.raises(ValueError, match="use their own ODE sampler"):
        serve(model, port=0, use_ddim_sampler=False, use_dpm_solver=True)


@pytest.fixture(scope="module")
def edit_batcher():
    batcher = BatchingSampler(_tiny_model(), IMG, max_batch=MAX_BATCH).start(warmup=False)
    yield batcher
    batcher.stop()


def test_edit_roundtrip(edit_batcher):
    """The JAX package's ``test_edit_serving_roundtrip`` cases: seeded
    determinism (and the model's ``edit`` on the seed), uint8 inputs (read
    as u8 / 255), strength 0 the input noised to t = 0 (one uint8 level), an
    oversized request chunked, and the refusals."""
    rng = np.random.default_rng(0)
    src = rng.uniform(0.1, 0.9, (3, IMG, IMG, 3)).astype(np.float32)
    out = edit_batcher.submit_edit(src, strength=0.6, seed=4, timeout=120)
    assert out.shape == (3, IMG, IMG, 3) and out.dtype == np.uint8
    assert np.array_equal(out, edit_batcher.submit_edit(src, strength=0.6, seed=4, timeout=120))
    padded = np.concatenate([src, np.zeros((MAX_BATCH - 3, IMG, IMG, 3), np.float32)])
    direct = edit_batcher.model.edit(torch.from_numpy(padded), 0.6, generator=torch.Generator().manual_seed(4),
                                     use_ema=True)
    assert np.array_equal(out, to_uint8_tensor(direct)[:3].numpy())
    u8 = (src * 255.0 + 0.5).astype(np.uint8)
    out_u8 = edit_batcher.submit_edit(u8, strength=0.6, seed=4, timeout=120)  # read as u8 / 255
    assert np.array_equal(out_u8, edit_batcher.submit_edit(u8.astype(np.float32) / 255.0, strength=0.6, seed=4,
                                                           timeout=120))
    # strength 0: only the forward noise to t = 0 separates the output from the input
    ident = edit_batcher.submit_edit(src, strength=0.0, seed=4, timeout=120)
    eps = torch.randn((MAX_BATCH, IMG, IMG, 3), generator=torch.Generator().manual_seed(4))[:3]
    c = edit_batcher.model.sampler.constants
    x = c.sqrt_alphas_cumprod[0] * (torch.from_numpy(src) * 2.0 - 1.0) + c.sqrt_one_minus_alphas_cumprod[0] * eps
    np.testing.assert_allclose(ident.astype(np.float32), to_uint8(((x + 1.0) * 0.5).numpy()).astype(np.float32),
                               atol=1.0)
    big = rng.uniform(0.1, 0.9, (MAX_BATCH + 2, IMG, IMG, 3)).astype(np.float32)
    assert edit_batcher.submit_edit(big, strength=0.6, seed=7, timeout=240).shape == (MAX_BATCH + 2, IMG, IMG, 3)
    with pytest.raises(ValueError, match="strength"):
        edit_batcher.submit_edit(src, strength=1.5, timeout=30)
    with pytest.raises(ValueError, match=r"\[n, H, W, C\]"):
        edit_batcher.submit_edit(src[0], timeout=30)
    with pytest.raises(ValueError, match="edit inputs"):
        edit_batcher.submit_edit(np.zeros((1, IMG * 2, IMG * 2, 3), np.float32), timeout=30)
    with pytest.raises(ValueError, match=r"\[0, 1\]"):
        edit_batcher.submit_edit(src * 255.0, strength=0.5, timeout=30)


def test_edit_requests_coalesce_per_strength():
    """Unseeded edits coalesce per strength, never with another strength or
    with /sample traffic."""
    batcher = BatchingSampler(_tiny_model(), IMG, max_batch=MAX_BATCH, linger_ms=300.0).start(warmup=False)
    src = np.random.default_rng(2).uniform(0, 1, (1, IMG, IMG, 3)).astype(np.float32)
    try:
        jobs = [lambda: batcher.submit_edit(src, 0.5, timeout=120), lambda: batcher.submit_edit(src, 0.5, timeout=120),
                lambda: batcher.submit_edit(src, 0.2, timeout=120), lambda: batcher.submit(1, timeout=120)]
        threads = [threading.Thread(target=job) for job in jobs]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
            assert not th.is_alive()
        stats = batcher.snapshot_stats()
        assert stats["requests"] == 4 and stats["batches"] == 3, stats
    finally:
        batcher.stop()


def test_held_worker_coalesces_requests_queued_past_the_linger_window():
    """Under ``hold`` the worker starts no batch: requests queued one after
    another, far apart against a 1 ms linger window, run as one batch on
    release, and a client's /stats read after its answer counts its batch."""
    batcher = BatchingSampler(_tiny_model(), IMG, max_batch=MAX_BATCH, linger_ms=1.0).start(warmup=False)
    src = np.random.default_rng(3).uniform(0, 1, (2, IMG, IMG, 3)).astype(np.float32)
    seen = []

    def job(n):
        batcher.submit_edit(src[:n], 0.5, timeout=120)
        seen.append(batcher.snapshot_stats()["batches"])

    try:
        threads = [threading.Thread(target=job, args=(n,)) for n in (1, 2)]
        with batcher.hold():
            for i, th in enumerate(threads):
                th.start()
                while batcher.queued() < i + 1:
                    time.sleep(0.001)
                time.sleep(0.05)  # 50 linger windows between the two arrivals
            assert batcher.queued() == 2 and batcher.snapshot_stats()["batches"] == 0
        for th in threads:
            th.join(timeout=120)
            assert not th.is_alive()
        stats = batcher.snapshot_stats()
        assert stats["batches"] == 1 and stats["requests"] == 2 and stats["images"] == 3, stats
        assert seen == [1, 1] and batcher.queued() == 0
    finally:
        batcher.stop()


def test_edit_http_surface(edit_batcher):
    """POST /edit: a seeded npy round trip; the JAX package's client faults
    (no images_npy, strength 7, bad base64, a non-numeric strength) answer
    400, not 500."""
    srv = SamplingServer(edit_batcher, port=0)
    srv.start_background()
    try:
        buf = io.BytesIO()
        np.save(buf, np.random.default_rng(1).uniform(0, 1, (2, IMG, IMG, 3)).astype(np.float32))
        blob = base64.b64encode(buf.getvalue()).decode("ascii")
        code, body = _call(srv, "POST", "/edit", {"images_npy": blob, "strength": 0.5, "seed": 2, "format": "npy"})
        assert code == 200 and np.load(io.BytesIO(body)).shape == (2, IMG, IMG, 3)
        code, body = _call(srv, "POST", "/edit", {"images_npy": blob, "strength": 0.5, "seed": 2})
        assert code == 200 and len(json.loads(body)["images"]) == 2
        for payload in ({"strength": 0.5}, {"images_npy": blob, "strength": 7.0},
                        {"images_npy": "!!!not-base64!!!", "strength": 0.5},
                        {"images_npy": blob, "strength": "a lot"}):
            assert _call(srv, "POST", "/edit", payload)[0] == 400, payload
    finally:
        srv._httpd.shutdown()
        srv._httpd.server_close()
