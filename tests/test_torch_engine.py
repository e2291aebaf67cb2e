"""The port's Engine and CLI `run` on the CPU, against the JAX Engine's
output and metric files (the committed goldens through the port are in
tests/test_torch_golden.py). Restored frames: tolerance 0."""

import json

import numpy as np
import pytest
import torch

from qcnn_gpu_tpu.data import yuv
from qcnn_gpu_tpu.data.model_files import read_psnr_goldens, write_static_qfp_vect_c
from qcnn_gpu_tpu.engine.runner import Engine as JEngine
from qcnn_gpu_tpu.testing import synth_engine_params, synth_frames
from qcnn_gpu_tpu_torch import cli
from qcnn_gpu_tpu_torch.engine.runner import Engine
from qcnn_gpu_tpu_torch.models.engine_params import EngineParams


@pytest.mark.parametrize("impl", ["auto", "kernel", "reference"])
def test_engine_restore_matches_jax_engine(impl):
    p = synth_engine_params(27)
    x = synth_frames(5, 19, 31, seed=2)
    eng = Engine(device="cpu", impl=impl, batch_frames=2)
    eng.set_model(27, EngineParams.from_arrays(p))
    jeng = JEngine(impl="int")
    jeng.set_model(27, p)
    want = jeng.restore(x, 27)
    assert (eng.restore(x, 27) == want).all()
    assert (eng.restore_stream(x, 27) == want).all()  # batches 2 + 2 + 1
    # the program is named for the generation that runs: kernel and auto are 3
    assert list(eng._programs) == [(27, "cpu", "reference" if impl == "reference" else "kernel3")]


def test_cli_run_matches_jax_cli(tmp_path, capsys):
    """cli run on disk artifacts: same reconstruction and the same three
    metric sinks as the JAX CLI."""
    from qcnn_gpu_tpu import cli as jcli

    ori = synth_frames(3, 22, 34, seed=4)
    anchor = np.clip(ori.astype(int) + np.random.default_rng(0).integers(-4, 5, ori.shape),
                     0, 255).astype(np.uint8)
    yuv.write_y_as_420(str(tmp_path / "ori.yuv"), ori)
    yuv.write_y_as_420(str(tmp_path / "anchor.yuv"), anchor)
    write_static_qfp_vect_c(str(tmp_path / "m.data"), synth_engine_params(37))
    args = ["run", "--ori", str(tmp_path / "ori.yuv"), "--anchor", str(tmp_path / "anchor.yuv"),
            "--height", "22", "--width", "34", "--frames", "3",
            "--model", str(tmp_path / "m.data"), "--qp", "37"]
    for name, mod, extra in (("port", cli, ["--device", "cpu"]), ("jax", jcli, ["--impl", "int"])):
        (tmp_path / name).mkdir()
        rc = mod.main(args + extra + ["--out-dir", str(tmp_path / name),
                                      "--recon", str(tmp_path / name / "recon.yuv")])
        assert rc == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("before net: PSNR=") and lines[0] == lines[3]
    assert lines[1].startswith("after quantized net: PSNR=") and lines[1] == lines[4]
    assert lines[2].startswith("time: ") and "impl=kernel3" in lines[2]
    rec = {n: yuv.read_y(str(tmp_path / n / "recon.yuv"), 22, 34, 3) for n in ("port", "jax")}
    assert (rec["port"] == rec["jax"]).all()
    runs = {n: json.loads((tmp_path / n / "runs.jsonl").read_text()) for n in ("port", "jax")}
    for key in ("sequence", "qp", "frames", "height", "width", "psnr_before", "psnr_after"):
        assert runs["port"][key] == runs["jax"][key], key
    assert runs["port"]["device"] == "cpu" and runs["port"]["impl"] == "kernel3"
    logs = {n: (tmp_path / n / "log.txt").read_text().splitlines() for n in ("port", "jax")}
    assert [ln.split(":")[0] for ln in logs["port"]] == [ln.split(":")[0] for ln in logs["jax"]]
    assert logs["port"][2:8] == logs["jax"][2:8]  # data .. after-PSNR lines
    psnr = {n: read_psnr_goldens(str(tmp_path / n / "recon_psnr.data")) for n in ("port", "jax")}
    assert (psnr["port"] == psnr["jax"]).all() and psnr["port"].shape == (1,)


def test_cli_sweep_matches_jax_cli(tmp_path, capsys):
    """cli sweep over a JSON manifest and two QPs: the same PSNRs and
    records as the JAX CLI's sweep."""
    from qcnn_gpu_tpu import cli as jcli

    manifest = tmp_path / "manifest.json"
    manifest.write_text(json.dumps([{"name": "Tiny_34x22_30", "cls": "X", "height": 22,
                                     "width": 34, "frames": 2}]))
    root = tmp_path / "data"
    (root / "HEVC_Sequence").mkdir(parents=True)
    (root / "anchor16.0").mkdir()
    ori = synth_frames(2, 22, 34, seed=5)
    yuv.write_y_as_420(str(root / "HEVC_Sequence" / "Tiny_34x22_30.yuv"), ori)
    for qp in (27, 37):
        noise = np.random.default_rng(qp).integers(-5, 6, ori.shape)
        anchor = np.clip(ori.astype(int) + noise, 0, 255).astype(np.uint8)
        yuv.write_y_as_420(str(root / "anchor16.0" / f"Tiny_intra_main_HM16.0_anchor_Q{qp}.yuv"),
                           anchor)
        write_static_qfp_vect_c(str(tmp_path / f"q{qp}.data"), synth_engine_params(qp))
    args = ["sweep", "--data-root", str(root), "--model-pattern", str(tmp_path / "q%d.data"),
            "--qps", "27,37", "--manifest", str(manifest)]
    assert cli.main(args + ["--device", "cpu", "--out-dir", str(tmp_path / "port")]) == 0
    assert jcli.main(args + ["--impl", "int", "--out-dir", str(tmp_path / "jax")]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 4 and lines[0].startswith("Tiny_34x22_30 QP27: ")
    assert [ln.split(" dB,")[0] for ln in lines[:2]] == [ln.split(" dB,")[0] for ln in lines[2:]]
    runs = {n: [json.loads(r) for r in (tmp_path / n / "runs.jsonl").read_text().splitlines()]
            for n in ("port", "jax")}
    for mine, theirs in zip(runs["port"], runs["jax"], strict=True):
        for key in ("sequence", "qp", "frames", "psnr_before", "psnr_after"):
            assert mine[key] == theirs[key], key
        assert mine["impl"] == "kernel3"


def test_cli_reports_missing_model(tmp_path, capsys):
    rc = cli.main(["run", "--ori", "o.yuv", "--anchor", "a.yuv", "--height", "8",
                   "--width", "8", "--model", str(tmp_path / "none.data"), "--qp", "37",
                   "--device", "cpu", "--out-dir", str(tmp_path)])
    assert rc == 1 and "cannot open model file" in capsys.readouterr().err


def test_cuda_device_never_falls_back_to_cpu():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a GPU")
    eng = Engine(device="cuda")
    eng.set_model(37, EngineParams.from_arrays(synth_engine_params(37)))
    with pytest.raises((RuntimeError, AssertionError)):
        eng.restore(np.zeros((1, 8, 8), np.uint8), 37)
