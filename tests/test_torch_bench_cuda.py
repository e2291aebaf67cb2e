"""The port's headline measurement and its layer tool on the card
(qcnn_gpu_tpu_torch/bench.py, tools/bench_layer.py).

`cli bench` at 4 frames of 416x240: one JSON line, the program exact
against the plain reference net on the card before any timing, generation
3 launched at the tuned table's tile (24x32 at 240p); `tools/bench_layer`
on one small layer, its GEMM route exact against the plain convolution.
Without a GPU every test skips. Imports no JAX module:
`python -m pytest --noconftest -m cuda tests/test_torch_bench_cuda.py`.
Tolerance: 0 (integer arithmetic)."""

import json

import pytest
import torch

from qcnn_gpu_tpu_torch import cli
from qcnn_gpu_tpu_torch.ops import fused as FU
from qcnn_gpu_tpu_torch.ops.int8_conv import conv_int8
from qcnn_gpu_tpu_torch.tools import bench_layer

SMALL = {"BENCH_H": "240", "BENCH_W": "416", "BENCH_BATCH": "4", "BENCH_ITERS": "4",
         "BENCH_HOST_WINDOWS": "1", "BENCH_HOST_BUDGET_S": "20"}


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")


@pytest.mark.cuda
def test_cli_bench_at_240p_on_the_card(monkeypatch, capsys):
    _cuda()
    for k, v in SMALL.items():
        monkeypatch.setenv(k, v)
    before = dict(FU.fused_forward.tile_launches)
    assert cli.main(["bench"]) == 0
    lines = capsys.readouterr().out.splitlines()
    res = json.loads(lines[-1])
    d = res["detail"]
    assert d["exact_vs_xla_on_hw"] is True
    assert (d["impl"], d["tile"], d["backend"]) == ("kernel3", "24x32", "cuda")
    assert d["pool"] in ("video", "noise")
    assert d["mfu"]["device_kind"] == torch.cuda.get_device_name(0)
    assert res["value"] > 0 and d["fps_incl_host_transfers"] > 0
    assert FU.fused_forward.tile_launches[24, 32] > before[24, 32]
    assert all(FU.fused_forward.tile_launches[t] == before[t] for t in FU.TILES if t != (24, 32))


@pytest.mark.cuda
def test_bench_layer_on_the_card(capsys):
    _cuda()
    before = conv_int8.launches
    res = bench_layer.main(["--layer", "C3_1", "--height", "240", "--width", "416",
                            "--batch", "2", "--iters", "2"])
    assert conv_int8.launches > before
    assert res["us_per_frame"] > 0 and res["bound_us_per_frame"] > 0
    assert capsys.readouterr().out.startswith("C3_1 3x3 48->16 @416x240: ")
