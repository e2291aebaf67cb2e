"""The frame-pair kernel (qcnn_gpu_tpu_torch/ops/pair.py) and the
engine's kernel generations.

On the CPU: the plain version `pair_forward_reference` equal to the Pallas
TPU kernel `build_pallas_forward2` (interpret mode) and to the oracle, odd
batches included; the `kernel2` engine path and `cli run --impl kernel2
--device cpu` equal to `kernel3`; each `--impl` name running its
generation (`kernel` and `auto` are generation 3), whatever the JAX
package's tuning environment says. On a GPU (skipped here): the CUDA
kernel equal to its plain version. Tolerance: 0 everywhere.

No JAX module is imported at the top of this file, so that the CUDA test
also runs on a GPU machine without jax:
`python -m pytest --noconftest -m cuda tests/test_torch_pair.py`."""

import json
import os

import numpy as np
import pytest
import torch

from qcnn_gpu_tpu_torch import cli
from qcnn_gpu_tpu_torch.data import yuv
from qcnn_gpu_tpu_torch.data.model_files import read_static_qfp_vect_c, write_static_qfp_vect_c
from qcnn_gpu_tpu_torch.engine.runner import Engine
from qcnn_gpu_tpu_torch.models.engine_params import EngineParams
from qcnn_gpu_tpu_torch.ops import fused as FU
from qcnn_gpu_tpu_torch.ops import pair as PA

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GENERATION = {"kernel2": PA.pair_forward, "kernel3": FU.fused_forward}


def _synth(qp):
    from qcnn_gpu_tpu.testing import synth_engine_params

    return synth_engine_params(qp)


def _frames(n, h, w, seed):
    from qcnn_gpu_tpu.testing import synth_frames

    return synth_frames(n, h, w, seed=seed)


@pytest.mark.parametrize("n,h,w,qp", [(1, 37, 53, 22), (2, 40, 300, 27), (3, 18, 250, 37)])
def test_plain_matches_pallas_v2_and_oracle(n, h, w, qp):
    from qcnn_gpu_tpu.models import oracle as O
    from qcnn_gpu_tpu.ops.pallas_pipeline2 import build_pallas_forward2

    jp = _synth(qp)
    x = _frames(n, h, w, seed=n + h)
    fw = FU.FusedWeights.from_engine(EngineParams.from_arrays(jp), "cpu")
    got = PA.pair_forward_reference(torch.from_numpy(x), fw).numpy()
    assert (got == np.asarray(build_pallas_forward2(jp, th=8, interpret=True)(x))).all()
    assert (got == O.forward_blu(x, jp)).all()


def test_cpu_tensor_takes_the_plain_version():
    fw = FU.FusedWeights.from_engine(EngineParams.from_arrays(_synth(37)), "cpu")
    x = torch.from_numpy(_frames(3, 19, 23, seed=3))
    before = PA.pair_forward.launches
    assert torch.equal(PA.pair_forward(x, fw), FU.fused_forward_reference(x, fw))
    assert PA.pair_forward.launches == before
    with pytest.raises(ValueError, match="contiguous"):
        PA.pair_forward(torch.zeros((2, 8, 16), dtype=torch.uint8)[:, :, ::2], fw)


def test_engine_kernel2_equals_kernel3():
    p = EngineParams.from_arrays(_synth(27))
    x = _frames(5, 19, 31, seed=2)
    out = {}
    for impl in ("kernel2", "kernel3"):
        eng = Engine(device="cpu", impl=impl, batch_frames=3)
        eng.set_model(27, p)
        out[impl] = eng.restore_stream(x, 27)  # batches 3 + 2
        assert list(eng._programs) == [(27, "cpu", impl)]
        assert eng._programs[(27, "cpu", impl)].func is GENERATION[impl]
    assert (out["kernel2"] == out["kernel3"]).all()


def test_cli_run_kernel2_equals_kernel3(tmp_path, capsys):
    ori = _frames(3, 22, 34, seed=4)
    anchor = np.clip(ori.astype(int) + np.random.default_rng(0).integers(-4, 5, ori.shape),
                     0, 255).astype(np.uint8)
    yuv.write_y_as_420(str(tmp_path / "ori.yuv"), ori)
    yuv.write_y_as_420(str(tmp_path / "anchor.yuv"), anchor)
    write_static_qfp_vect_c(str(tmp_path / "m.data"), EngineParams.from_arrays(_synth(37)))
    recon = {}
    for impl in ("kernel2", "kernel3"):
        out = tmp_path / impl
        rc = cli.main(["run", "--ori", str(tmp_path / "ori.yuv"),
                       "--anchor", str(tmp_path / "anchor.yuv"), "--height", "22",
                       "--width", "34", "--frames", "3", "--model", str(tmp_path / "m.data"),
                       "--qp", "37", "--device", "cpu", "--impl", impl,
                       "--out-dir", str(out), "--recon", str(out / "recon.yuv")])
        assert rc == 0
        assert json.loads((out / "runs.jsonl").read_text())["impl"] == impl
        recon[impl] = yuv.read_y(str(out / "recon.yuv"), 22, 34, 3)
    assert (recon["kernel2"] == recon["kernel3"]).all()
    assert "impl=kernel2" in capsys.readouterr().out


@pytest.mark.parametrize("impl,name", [
    ("auto", "kernel3"), ("kernel", "kernel3"), ("kernel3", "kernel3"), ("kernel2", "kernel2"),
    ("reference", "reference"),
])
def test_impl_runs_its_generation(impl, name):
    p = EngineParams.from_arrays(_synth(37))
    eng = Engine(device="cpu", impl=impl, batch_frames=2)
    eng.set_model(37, p)
    assert eng.program_name(37) == name
    x = _frames(3, 9, 11, seed=1)
    want = FU.fused_forward_reference(torch.from_numpy(x), FU.FusedWeights.from_engine(p, "cpu")).numpy()
    assert (eng.restore_stream(x, 37) == want).all()
    run = eng._programs[(37, "cpu", name)]
    assert getattr(run, "func", None) is GENERATION.get(name)


def test_tpu_tuning_settings_never_reach_the_port(monkeypatch, tmp_path):
    """The JAX package's tuned table and its environment knobs select the
    TPU kernel; none of them moves the port off generation 3."""
    table = tmp_path / "tuned_kernel.json"
    table.write_text(json.dumps({"kernel": 2, "per_geometry": {"9x11": {"kernel": 2}}}))
    monkeypatch.setenv("QCNN_KERNEL_KERNEL", "2")
    monkeypatch.setenv("QCNN_KERNEL_CONFIG", str(table))
    for impl in ("auto", "kernel"):
        eng = Engine(device="cpu", impl=impl)
        eng.set_model(37, EngineParams.from_arrays(_synth(37)))
        assert eng.program_name(37) == "kernel3"


def test_unknown_impl_and_generation_raise():
    with pytest.raises(ValueError, match="impl must be one of"):
        Engine(device="cpu", impl="kernel4")
    with pytest.raises(ValueError, match="impl must be one of"):
        Engine(device="cpu", impl="pallas2")


@pytest.mark.cuda
def test_cuda_kernel_matches_plain():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    p = read_static_qfp_vect_c(os.path.join(REPO, "assets", "golden", "model_q37.data"))
    fw = FU.FusedWeights.from_engine(p, "cuda")
    rng = np.random.default_rng(7)
    for shape in ((1, 37, 53), (2, 13, 245), (3, 40, 50)):  # odd batches included
        x = torch.from_numpy(rng.integers(0, 256, shape, dtype=np.uint8)).cuda()
        got = PA.pair_forward(x, fw)
        torch.cuda.synchronize()
        assert torch.equal(got, PA.pair_forward_reference(x, fw)), shape
