"""The port's MFU accounting (qcnn_gpu_tpu_torch/engine/mfu.py) on the CPU:
the useful MACs equal the JAX package's and the topology's, the Hopper
pass model counts the `wgmma` MACs the kernels issue at each compiled
tile (77,210 a pixel at 24x40, tests/test_torch_pair_split.py's count),
the card's peaks are the data sheet's for the H100 alone and one constant
with the tools', and `mfu_report` is self-consistent
(tests/test_mfu.py's case, with the H100's peaks)."""

import pytest

from qcnn_gpu_tpu.engine import mfu as JM
from qcnn_gpu_tpu_torch import tools
from qcnn_gpu_tpu_torch.engine import mfu as M
from qcnn_gpu_tpu_torch.models.topology import MACS_PER_PIXEL
from qcnn_gpu_tpu_torch.ops import fused as FU

H100 = "NVIDIA H100 80GB HBM3"


def test_useful_macs_equal_jax_and_the_topology():
    assert M.USEFUL_MACS_PER_PX == JM.USEFUL_MACS_PER_PX == MACS_PER_PIXEL == 54512


@pytest.mark.parametrize("tile,issued", [((24, 40), 77210), ((24, 32), 82176), ((32, 32), 79232)])
def test_pass_model_issued_macs(tile, issued):
    pm = M.pass_model_summary(tile)
    assert round(pm["issued_macs_per_px"]) == issued
    assert pm["useful_macs_per_px"] == M.USEFUL_MACS_PER_PX
    assert sum(s["useful_macs_per_px"] for s in pm["stages"].values()) == M.USEFUL_MACS_PER_PX
    assert sum(s["issued_macs_per_px"] for s in pm["stages"].values()) == pytest.approx(
        pm["issued_macs_per_px"], abs=0.5)
    assert pm["structural_mfu_ceiling"] == pytest.approx(54512 / issued, abs=1e-4)
    assert [s["blocks"] for s in pm["stages"].values()] == list(FU.layout(*tile).blocks)
    assert [s["wgmma_per_block"] for s in pm["stages"].values()] == [1, 50, 14, 2]


@pytest.mark.parametrize("tile", [(16, 24), (20, 40)])
def test_pass_model_refuses_a_tile_that_is_not_compiled(tile):
    with pytest.raises(ValueError, match="not a compiled instance"):
        M.pass_model_summary(tile)


def test_chip_peaks():
    assert M.chip_peaks(H100) == (1979.0, 989.0)
    for kind in ("cpu", "", None, "TPU v5 lite", "NVIDIA H100 PCIe"):
        assert M.chip_peaks(kind) == (None, None)
    assert tools.PEAK_INT8_OPS is M.PEAK_INT8_OPS  # one constant for the tools and the report
    assert M.chip_peaks(H100)[0] * 1e12 == tools.PEAK_INT8_OPS


def test_mfu_report_consistency():
    r = M.mfu_report(1920 * 1080, 0.5311, H100)
    # 54,512 MACs/px x 2.07 Mpx / 0.5311 ms = ~425.7 TOP/s
    assert r["sustained_useful_tops"] == pytest.approx(425.7, abs=0.5)
    assert r["mfu_vs_int8_peak"] == pytest.approx(r["sustained_useful_tops"] / 1979, abs=1e-4)
    assert r["mfu_vs_bf16_peak"] == pytest.approx(2 * r["mfu_vs_int8_peak"], abs=2e-3)
    assert r["issued_macs_per_px"] == pytest.approx(77209.6)
    assert r["pass_model"] == M.pass_model_summary()
    cpu = M.mfu_report(1920 * 1080, 0.5311, "cpu")
    assert cpu["mfu_vs_int8_peak"] is None and cpu["peak_tops_int8"] is None
    assert M.mfu_report(240 * 416, 0.03, H100, (24, 32))["pass_model"]["tile"] == "24x32"
