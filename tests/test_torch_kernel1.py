"""Generation 1 (the literal-requant kernel) as an engine program, on the
CPU: tables moved out of the solver's saturation window run through
`Engine(impl="kernel1")`, through `auto` (which picks generation 1 for
them) and through `cli run` over the raw and the duplex transports, equal
to the numpy oracle; `kernel`/`kernel3` keep refusing them, and `auto`
raises, naming `--impl reference`, for a table no kernel computes.
Tolerance: 0 (restored frames)."""

import dataclasses
import json

import numpy as np
import pytest

from qcnn_gpu_tpu.data import yuv
from qcnn_gpu_tpu.data.model_files import write_static_qfp_vect_c
from qcnn_gpu_tpu.models import oracle as O
from qcnn_gpu_tpu.testing import synth_engine_params, synth_frames
from qcnn_gpu_tpu_torch import cli
from qcnn_gpu_tpu_torch.engine.runner import Engine
from qcnn_gpu_tpu_torch.models.engine_params import EngineParams
from test_torch_literal import _moved


def _scene(n, h, w, seed):
    """A still background with a small patch that changes every frame:
    content on which the duplex's packed steps beat raw both ways."""
    rng = np.random.default_rng(seed)
    fr = np.broadcast_to(rng.integers(0, 256, (h, w), np.uint8), (n, h, w)).copy()
    for i in range(n):
        fr[i, 30:36, 20 + 4 * i:26 + 4 * i] = rng.integers(0, 256, (6, 6), np.uint8)
    return fr


@pytest.mark.parametrize("layer,sign", [(0, -1), (2, +1), (4, -1)])
def test_engine_serves_moved_tables_with_generation_1(layer, sign):
    jp = _moved(synth_engine_params(37), layer, sign)
    x = synth_frames(5, 19, 31, seed=layer)
    want = O.forward_blu(x, jp)
    for impl in ("kernel1", "auto"):
        eng = Engine(device="cpu", impl=impl, batch_frames=2)
        eng.set_model(37, EngineParams.from_arrays(jp))
        assert eng.program_name(37) == "kernel1"
        assert (eng.restore(x, 37) == want).all()
        assert (eng.restore_stream(x, 37) == want).all()
        assert list(eng._programs) == [(37, "cpu", "kernel1")]
    for impl in ("kernel", "kernel3"):
        eng = Engine(device="cpu", impl=impl)
        eng.set_model(37, EngineParams.from_arrays(jp))
        with pytest.raises(ValueError, match="saturation window"):
            eng.restore(x, 37)


def test_auto_raises_for_a_table_no_kernel_computes():
    jp = synth_engine_params(37)
    mul = list(jp.mul)
    mul[5] = 129  # odd, so nothing normalizes it below generation 1's limit of 127
    blu = list(jp.blu_q)
    blu[2] += 1 << 20  # and out of the saturation window
    bad = dataclasses.replace(jp, mul=tuple(mul), blu_q=tuple(blu))
    eng = Engine(device="cpu", impl="auto")
    eng.set_model(37, EngineParams.from_arrays(bad))
    with pytest.raises(ValueError, match="--impl reference") as err:
        eng.restore(np.zeros((1, 8, 8), np.uint8), 37)
    assert "saturation window" in str(err.value) and "final mul 129" in str(err.value)
    ref = Engine(device="cpu", impl="reference")
    ref.set_model(37, EngineParams.from_arrays(bad))
    x = synth_frames(2, 12, 17, seed=1)
    assert (ref.restore(x, 37) == O.forward_blu(x, bad)).all()


def test_cli_run_serves_moved_table_over_raw_and_duplex(tmp_path, capsys):
    """`cli run` with --impl kernel1 and auto over both transports: impl
    kernel1 and kernel1+duplex, recon equal to the oracle's, a packed
    duplex step; --impl kernel exits 1 with the window message."""
    jp = _moved(synth_engine_params(37), 2, +1)
    ori = _scene(8, 64, 161, seed=4)
    anchor = np.clip(ori.astype(int) + np.random.default_rng(1).integers(-3, 4, ori.shape[1:]),
                     0, 255).astype(np.uint8)
    yuv.write_y_as_420(str(tmp_path / "ori.yuv"), ori)
    yuv.write_y_as_420(str(tmp_path / "anchor.yuv"), anchor)
    write_static_qfp_vect_c(str(tmp_path / "m.data"), jp)
    want = O.forward_blu(anchor, jp)
    args = ["run", "--ori", str(tmp_path / "ori.yuv"), "--anchor", str(tmp_path / "anchor.yuv"),
            "--height", "64", "--width", "161", "--frames", "8", "--model",
            str(tmp_path / "m.data"), "--qp", "37", "--device", "cpu"]
    for impl in ("kernel1", "auto"):
        for transport in ("raw", "duplex"):
            out = tmp_path / f"{impl}-{transport}"
            assert cli.main(args + ["--impl", impl, "--transport", transport,
                                    "--out-dir", str(out), "--recon", str(out / "r.yuv")]) == 0
            rec = json.loads((out / "runs.jsonl").read_text())
            assert rec["impl"] == "kernel1" + ("+duplex" if transport == "duplex" else "")
            assert (yuv.read_y(str(out / "r.yuv"), 64, 161, 8) == want).all()
            if transport == "duplex":
                assert rec["transport"]["packed_steps"] >= 1
    assert "impl=kernel1+duplex" in capsys.readouterr().out
    assert cli.main(args + ["--impl", "kernel", "--out-dir", str(tmp_path / "k")]) == 1
    assert "saturation window" in capsys.readouterr().err
