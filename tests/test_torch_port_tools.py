"""The port's kernel microbenchmarks (``diffusion_model_nemo_tpu_torch/tools``)
on the CPU, at tiny shapes.

On the CPU every kernel call runs its plain version, so these tests check the
tools' arms, rows and printed lines, and hold the arms that have a JAX
counterpart to it (inputs from numpy seeds fed to both packages); the times
they print are the host's and say nothing of the card. bf16 at rtol = atol =
2e-2, the JAX package's kernel-test tolerance.
"""

import json
import math
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_model_nemo_tpu.ops import attention as JA
from diffusion_model_nemo_tpu_torch.ops import conv as TC
from diffusion_model_nemo_tpu_torch.tools import microbench_attn as MA
from diffusion_model_nemo_tpu_torch.tools import microbench_attn_lanes as ML
from diffusion_model_nemo_tpu_torch.tools import microbench_conv as MC

REPO = Path(__file__).resolve().parents[1]
BF16_TOL = 2e-2
FAST = dict(device="cpu", reps=1, rounds=1)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _finite_rows(rows):
    assert rows and all(math.isfinite(r["us"]) and r["us"] > 0 and r["device"] == "cpu" for r in rows)


def test_microbench_attn_runs_on_cpu():
    rows = MA.run(shapes=[(2, 64, 32), (2, 64, 64)], **FAST)
    _finite_rows(rows)
    assert [(r["shape"], r["arm"]) for r in rows] == [
        ([2, 64, C], arm) for C in (32, 64) for arm in ("composed", "v1", "v2")
    ]
    # v2's max |diff| against composed is that of the two arms' outputs, which
    # agree at rtol = atol = 2e-2
    for row in (r for r in rows if "max_abs_diff" in r):
        B, N, C = row["shape"]
        x = torch.from_numpy(np.random.default_rng(0).standard_normal((B, N, C))).float().bfloat16()
        arms = MA.arms(C, torch.device("cpu"))
        v2, composed = arms["v2"](x).float(), arms["composed"](x).float()
        torch.testing.assert_close(v2, composed, rtol=BF16_TOL, atol=BF16_TOL)
        assert row["max_abs_diff"] == float((v2 - composed).abs().max())
    lines = MA.report(rows)
    assert lines[0].startswith("[2,64,32] composed") and lines[-1].startswith("[2,64,64] v2 max|d|=")


def test_microbench_attn_composed_arm_matches_jax():
    """The tool's composed arm against the JAX tool's composition on the
    same weights: GroupNorm(1), qkv, ``fused_linear_attention_qkv``, out
    projection, GroupNorm(1), + x (bf16, 2e-2)."""
    B, N, C = 2, 64, 32
    x = np.random.default_rng(3).standard_normal((B, N, C))
    ng, nb, wqkv, wout, bout, og, ob = (t.numpy() for t in MA._weights(C, torch.device("cpu")))
    ours = MA.arms(C, torch.device("cpu"))["composed"](torch.from_numpy(x).float().bfloat16())
    jx = jnp.asarray(x, jnp.float32).astype(jnp.bfloat16)
    h = JA._gn1(jx, ng, nb, 1e-5)
    attn = JA.fused_linear_attention_qkv(jnp.dot(h, wqkv.astype(h.dtype)), 4, 32, 32**-0.5)
    out = jnp.dot(attn.astype(jx.dtype), wout.astype(jx.dtype)) + bout.astype(jx.dtype)
    ref = JA._gn1(out, og, ob, 1e-5) + jx
    np.testing.assert_allclose(ours.float().numpy(), np.asarray(ref, np.float32), rtol=BF16_TOL, atol=BF16_TOL)


def test_microbench_conv_runs_on_cpu():
    rows = MC.run(shapes=[(2, 8, 8, 32, 32), (2, 8, 8, 32, 16)], **FAST)
    _finite_rows(rows)
    assert [r["arm"] for r in rows] == ["conv2d", "conv3x3"] * 2
    assert all(r["max_abs_diff"] <= BF16_TOL for r in rows if r["arm"] == "conv3x3")
    assert rows[0]["gflop"] == 2 * 2 * 8 * 8 * 9 * 32 * 32 / 1e9
    lines = MC.report(rows)
    assert lines[0].startswith("[2,8,8,32->32] conv2d") and lines[1].startswith("   conv3x3:")


def test_microbench_conv_library_arm_computes_the_same_conv():
    """The yardstick ``F.conv2d`` call on the channels_last view computes
    what ``conv3x3_reference`` computes (bf16, 2e-2)."""
    x, w, b = MC.inputs((2, 8, 8, 32, 16), torch.device("cpu"))
    lib = MC.library_conv(x, w, b)().permute(0, 2, 3, 1)
    torch.testing.assert_close(lib.float(), TC.conv3x3_reference(x, w, b).float(), rtol=BF16_TOL, atol=BF16_TOL)


def test_microbench_attn_lanes_runs_on_cpu():
    rows = ML.run(shapes=[(2, 64, 32)], transposes=[(64, 128), (96, 128)], **FAST)
    _finite_rows(rows)
    assert [r["arm"] for r in rows] == ["v3", "v4", "transpose", "transpose"]
    assert all(r["max_abs_diff"] <= BF16_TOL for r in rows[:2])
    assert all(r["exact"] and r["copy_us"] > 0 for r in rows[2:])
    lines = ML.report(rows)
    assert lines[1].startswith("[2,64,32] v4:") and lines[2].startswith("transpose [64,128] bf16")


def test_v4_call_is_the_tokens_function_on_the_packed_view():
    """``v4_call`` on [B, N, C] equals the qkv-fused linear attention on the
    same tokens: the packed view holds the same bytes."""
    B, N, C = 2, 64, 64
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((B, N, C))).float().bfloat16()
    w = torch.from_numpy(rng.standard_normal((C, 384)) * 0.1).float()
    from diffusion_model_nemo_tpu_torch.ops import attention as TA

    ours = ML.v4_call(x, w, 4, 32, 32**-0.5)
    torch.testing.assert_close(ours, TA.linear_attention_tokens_reference(x, w, 4, 32, 32**-0.5), rtol=0, atol=0)


@pytest.mark.parametrize(
    "tool,argv,expect",
    [
        (MA, ["--shape", "2", "64", "32"], "[2,64,32] v2 max|d|="),
        (MC, ["2", "8", "8", "32", "32"], "[2,8,8,32->32] conv2d"),
        (ML, ["--shape", "2", "64", "32", "--transpose", "64", "128"], "transpose [64,128] bf16"),
    ],
    ids=["attn", "conv", "attn_lanes"],
)
def test_tool_main_prints_the_jax_tools_lines(capsys, tool, argv, expect):
    assert tool.main(argv + ["--device", "cpu", "--reps", "1", "--rounds", "1"]) == 0
    out = capsys.readouterr().out
    assert expect in out


def test_microbench_conv_rejects_a_partial_shape():
    with pytest.raises(SystemExit):
        MC.main(["2", "8", "8", "32", "--device", "cpu"])


@pytest.mark.parametrize("name", ["microbench_attn", "microbench_conv", "microbench_attn_lanes"])
def test_tool_runs_as_a_module_without_jax(name):
    """``python -m diffusion_model_nemo_tpu_torch.tools.<name>`` in a fresh
    interpreter (this one has JAX loaded by conftest): it runs, and neither
    JAX nor the JAX package is imported."""
    small = {
        "microbench_attn": ["--shape", "2", "64", "32"],
        "microbench_conv": ["2", "8", "8", "32", "32"],
        "microbench_attn_lanes": ["--shape", "2", "64", "32", "--transpose", "64", "128"],
    }[name]
    argv = ["x", *small, "--device", "cpu", "--reps", "1", "--rounds", "1"]
    code = (
        "import runpy, sys\n"
        f"sys.argv = {argv!r}\n"
        "try:\n"
        f"    runpy.run_module('diffusion_model_nemo_tpu_torch.tools.{name}', run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    assert e.code == 0, e.code\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'diffusion_model_nemo_tpu'))\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", code], check=True, cwd=REPO, env=env, timeout=300,
                         capture_output=True, text=True)
    assert "us" in out.stdout


def test_check_attention_needs_a_card_and_reads_ptxas_reports(tmp_path, monkeypatch, capsys):
    """The card check of kernels #7 and #4 refuses to run without a CUDA
    device (it never falls back to the plain versions), and reads a build
    log's per-kernel resource lines."""
    from diffusion_model_nemo_tpu_torch.ops import _build
    from diffusion_model_nemo_tpu_torch.tools import check_attention as CA

    assert CA.main() == 2
    assert "no CUDA device" in capsys.readouterr().err
    (tmp_path / "attention-0123.log").write_text(
        "ptxas info    : Compiling entry function 'attn_wgmma_kernel' for 'sm_90a'\n"
        "ptxas info    : Function properties for attn_wgmma_kernel\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 122 registers, used 1 barriers\n"
    )
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    assert list(CA.ptxas_report("attention")) == [
        ("attn_wgmma_kernel", "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads | "
                              "Used 122 registers, used 1 barriers")
    ]


def test_check_conv_norm_needs_a_card(capsys):
    """The card check of kernels #11, #6, #1 and #5 refuses to run without a
    CUDA device (it never falls back to the plain versions), its edge shapes
    take both forms of the bf16 conv, #1's sites are unet_small's 35 a
    forward, and its corners take all three of #1's forms (a share in
    registers, in shared memory, a slab read twice), the shared one also
    with element-wise pieces."""
    from diffusion_model_nemo_tpu_torch.ops import conv as TC
    from diffusion_model_nemo_tpu_torch.ops import norm as TN
    from diffusion_model_nemo_tpu_torch.tools import check_conv_norm as CCN

    assert CCN.main() == 2
    assert "no CUDA device" in capsys.readouterr().err
    routes = {TC.conv3x3_route(Fo) for _B, _H, _W, _C, Fo in CCN.CONV_EDGE_SHAPES}
    assert routes == {"mma", "wgmma"}
    assert sum(CCN.GN_SITES.values()) == 35
    plans = [TN.group_norm_plan(H * W, C, 8 if C % 8 == 0 else 4, dt)
             for (_B, H, W, C), dt, _px in CCN.GN_CORNERS]
    assert {(p.form, p.vec) for p in plans} >= {("registers", True), ("shared", True), ("shared", False), ("twice", True)}


def test_ab_chip_needs_a_card_and_replaces_every_measurement(capsys):
    """The A/B runner refuses to run without a CUDA device, before it touches
    the import path; every function it lends to a checkout's chip_smoke is in
    the shared measurement module, and this checkout's chip_smoke measures
    through that module."""
    from diffusion_model_nemo_tpu_torch.tools import ab_chip as AB
    from diffusion_model_nemo_tpu_torch.tools import profiling as P

    path = list(sys.path)
    assert AB.main([str(REPO)]) == 2
    assert "no CUDA device" in capsys.readouterr().err
    assert sys.path == path
    assert all(callable(getattr(P, name)) for name in AB.MEASUREMENT)
    smoke = (REPO / "chip_smoke.py").read_text()
    assert "from diffusion_model_nemo_tpu_torch.tools.profiling import" in smoke
    assert not any(f"def {name}(" in smoke for name in AB.MEASUREMENT)


def test_ab_chip_compares_two_dumps_bit_for_bit(tmp_path, capsys):
    """``--compare`` holds the output digests two trees saved with ``--dump``
    equal, without a card: equal files pass, one changed digest fails and is
    named; the modes it dumps are the card check's."""
    from diffusion_model_nemo_tpu_torch.tools import ab_chip as AB
    from diffusion_model_nemo_tpu_torch.tools import check_linattn as CL

    key = "linear_attention_block [64, 1024, 32] bfloat16"
    x = {key: "9f" * 32, "linear_attention_v4 [128, 256, 64] float32": "0a" * 32}
    a, b = tmp_path / "a.json", tmp_path / "b.json"
    a.write_text(json.dumps(x))
    b.write_text(json.dumps(dict(x)))
    assert AB.main(["--compare", str(a), str(b)]) == 0
    b.write_text(json.dumps(dict(x, **{key: "9e" + "9f" * 31})))
    assert AB.main(["--compare", str(a), str(b)]) == 1
    assert f"DIFFERS: {key}" in capsys.readouterr().out
    assert all(name in CL.KERNELS and name in CL.PATH_SHAPES for name in AB.BLOCK_MODES)


def test_conv_bound_over_the_tool_shapes():
    """The shared bound (``profiling.bound_us``: bytes at 3.35 TB/s or bf16
    operations at 989 TFLOP/s, the larger) of the 3x3 conv over the
    microbenchmark's six shapes, with its bf16 x, w and b, is 65.44 us, and
    only 128->128 is bound by its operations."""
    from diffusion_model_nemo_tpu_torch.tools import profiling as P

    total, by_ops = 0.0, []
    for B, H, W, C, Fo in MC.SHAPES:
        args = tuple(torch.empty(s, dtype=torch.bfloat16, device="meta")
                     for s in ((B, H, W, C), (3, 3, C, Fo), (Fo,)))
        nbytes, ops, kind = P.work("conv3x3", args)
        assert kind == "bf16" and ops == 2 * B * H * W * 9 * C * Fo
        total += P.bound_us("conv3x3", args)
        if ops / P.PEAK_OPS[kind] > nbytes / P.PEAK_BYTES_PER_S:
            by_ops.append(C)
    assert abs(total - 65.44) < 0.01 and by_ops == [128]


def test_check_linattn_needs_a_card_and_formats_its_rows(capsys):
    """The card check of kernels #2, #9, #10, #3, #12 and #8 refuses to run
    without a CUDA device (it never falls back to the plain versions); a
    checked call is one line with its hold, launches, repeat and, where
    timed, its device time beside the bound; its path shapes are the plan's
    resident ones, #8's N = 4096 corner reloads its tiles, and its seeded
    inputs have the block's shapes."""
    from diffusion_model_nemo_tpu_torch.ops import attention as TA
    from diffusion_model_nemo_tpu_torch.tools import check_linattn as CL

    assert CL.main() == 2
    assert "no CUDA device" in capsys.readouterr().err
    row = {"kernel": "linear_attention_block", "shape": (64, 1024, 32), "dtype": "bfloat16",
           "plan": "8x128 90624 B", "max_abs_err": 0.015625, "ok": True, "tol": 0.02, "kernels": 1,
           "repeat": True, "mirrored": True}
    line = CL.format_row(row)
    assert line == ("[check] linear_attention_block [64, 1024, 32] bfloat16 plan=8x128 90624 B "
                    "max_abs_err=1.562e-02 ok=True (rtol = atol = 0.02) kernels/call=1 repeat_bitwise=True "
                    "plan_bytes_mirrored=True")
    timed = CL.format_row(dict(row, dev_us=70.25, queued_us=71.5, bound_us=3.257))
    assert timed == line + " | dev 70.25 us, queued 71.50 us, bound 3.257 us"
    assert set(CL.KERNELS) == {"linear_attention_block", "linear_attention_block_v1", "linear_attention_block_v2",
                               "linear_attention_tokens", "linear_attention_v4", "linear_attention_qkv"}
    assert all(callable(getattr(TA, attr)) for pair in CL.KERNELS.values() for attr in pair)
    for name, shapes in CL.PATH_SHAPES.items():
        assert all(CL.plan(name, shape, CL.PATH_DTYPE.get(name, torch.bfloat16)).resident for shape in shapes)
    assert not TA.linattn_block_plan(4096, 128, torch.bfloat16).resident  # a corner takes the other form
    assert not all(TA.linattn_block_plan(N, C, torch.bfloat16, core=True).resident
                   for _B, N, C in CL.CORE_CORNER_SHAPES)
    for dt in (torch.bfloat16, torch.float32):  # #8's N = 4096 corner reloads its tiles, on 16 CTAs
        plans = [CL.plan("linear_attention_qkv", shape, dt) for shape in CL.QKV_CORNER_SHAPES]
        assert [(p.cluster, p.resident) for p in plans] == [(16, False), (1, True), (1, True)]
    assert CL.plan("linear_attention_qkv", (64, 1024, 384), torch.float32) == \
        TA.linattn_block_plan(1024, 384, torch.float32, raw=True)
    qkv = CL.qkv_args((2, 104, 384), torch.float32, torch.Generator().manual_seed(0), "cpu")
    assert qkv[0].shape == (2, 104, 384) and qkv[1:] == (4, 32, 32**-0.5)
    assert sum(CL.PATH_CALLS.get(s, 1) for s in CL.PATH_SHAPES["linear_attention_qkv"]) == 5
    seam = CL.format_row(dict(row, seam_step=7.0e-4, differ=0.0025))
    assert seam == line + " | seam: max_abs_err <= 7.000e-04 (one bf16 step), differ 0.0025"
    h, w, N = CL.core_args("linear_attention_v4", (2, 64, 32), torch.bfloat16, torch.Generator().manual_seed(0),
                           "cpu")[:3]
    assert h.shape == (2, 16, 128) and w.shape == (32, 384) and N == 64
    args = CL.block_args((2, 100, 40), torch.bfloat16, torch.Generator().manual_seed(0), "cpu")
    assert args[0].shape == (2, 100, 40) and args[0].dtype == torch.bfloat16
    assert args[3].shape == (40, 384) and args[4].shape == (128, 40) and args[8:] == (4, 32, 32**-0.5, 1e-5)


class _StubTrace:
    """A torch.profiler stand-in whose traces hold the given device events
    (name, us): the card's profiler cannot run here."""

    def __init__(self, names):
        self.names, self.opened = names, 0

    def __call__(self, activities=None):
        stub = self

        class Prof:
            def __enter__(self):
                stub.opened += 1
                return self

            def __exit__(self, *exc):
                return False

            def events(self):
                return [type("E", (), {"name": n, "device_type": torch.autograd.DeviceType.CUDA,
                                       "time_range": type("R", (), {"elapsed_us": lambda self, us=us: us})()})()
                        for n, us in stub.names]

        return Prof()


@pytest.mark.parametrize("names, expect, markers_after", [
    ([], None, 8),  # every attempt empty: the measurement fails, the markers stay
    ([("at::cuda::spin_kernel(long)", 5.0)], None, 8),  # only the markers kept: no event of the call
    ([("gn_silu_kernel", 2.0)], None, 1 << 14),  # the call's events, no marker: 4x a retake, to their cap
    ([("spin_kernel", 1100.0), ("gn_silu_kernel", 2.0)], None, 1 << 14),  # the lead spin is not a marker
    # One marker kept a trace: the next opens with twice the dropped ones (7, 13, 25).
    ([("spin_kernel", 5.0), ("gn_silu_kernel", 2.0)], [("gn_silu_kernel", 2.0)], 50),
], ids=["empty", "markers-only", "no-marker", "lead-only", "markers-and-kernel"])
def test_traced_raises_on_a_trace_that_may_have_dropped_events(monkeypatch, names, expect, markers_after):
    """``traced``, ``device_ms`` and ``kernel_launches`` never read an empty
    trace, nor one that kept none of the markers after its lead spin (the
    profiler drops a trace's first device events): after ``ATTEMPTS``
    traces, each that kept the call's events but no marker taken again with
    four times the markers, they raise ``EmptyTraceError``. A trace that kept
    markers sets the next one's to twice those it dropped."""
    import torch.profiler

    from diffusion_model_nemo_tpu_torch.tools import profiling as P

    stub = _StubTrace(names)
    spins = []
    monkeypatch.setattr(torch.profiler, "profile", stub)
    monkeypatch.setattr(torch.cuda, "_sleep", spins.append)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    monkeypatch.setattr(P, "tracing", {"markers": 8, "traces": 0, "retakes": 0, "seconds": 0.0, "dropped_max": 0})
    if expect is None:
        for measure in (lambda: P.traced(lambda: None), lambda: P.device_ms(lambda: None),
                        lambda: P.kernel_launches(lambda: None)):
            with pytest.raises(P.EmptyTraceError):
                measure()
        assert stub.opened == 3 * P.ATTEMPTS  # each: every attempt taken
        assert P.tracing["retakes"] == 3 * (P.ATTEMPTS - 1)
    else:
        assert P.traced(lambda: None) == expect
        assert P.kernel_launches(lambda: None) == [n for n, _ in expect]
        assert P.device_ms(lambda: None) == pytest.approx(2.0e-3)
        assert P.tracing["retakes"] == 0 and P.tracing["dropped_max"] == 25
    assert P.tracing["markers"] == markers_after and P.tracing["traces"] == stub.opened
    # Each trace opens with the lead (its cycles at the spin's clock) and the markers.
    assert spins[0] == P.LEAD_US * P.SPIN_CYCLES_PER_US and spins[1:9] == [1] * 8


def test_trace_events_reads_what_prof_events_gives():
    """``trace_events`` reads a finished trace's kineto results directly:
    on a real (CPU) trace it gives the names and durations that
    ``prof.events()`` gives, in the same order, exactly."""
    from torch.profiler import ProfilerActivity, profile

    from diffusion_model_nemo_tpu_torch.tools import profiling as P

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        x = torch.ones(32, 32)
        for _ in range(8):
            x = torch.softmax(x @ x.T * 0.01, dim=-1)
    cpu = torch.autograd.DeviceType.CPU
    fast = P.trace_events(prof, cpu)
    full = [(e.name, e.time_range.elapsed_us()) for e in prof.events() if e.device_type == cpu]
    assert len(fast) > 30 and fast == full
    assert P.trace_events(prof, torch.autograd.DeviceType.CUDA) == []
