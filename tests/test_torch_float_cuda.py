"""The float model's precision on a CUDA GPU: the BLU calibration with
full float32 convolutions (`float_model.fp32_convs`) against the CPU's,
and the same calibration with cuDNN's TF32 convolutions (the card's
default, which the float code turns off), to show what the setting buys.
Run on the card with
`python -m pytest --noconftest -m cuda -s tests/test_torch_float_cuda.py`
(`-s` prints the measured differences); without a GPU the test skips.
Imports no JAX module."""

import contextlib

import numpy as np
import pytest
import torch

from qcnn_gpu_tpu_torch import testing as T
from qcnn_gpu_tpu_torch.engine.calibrate import calibrate_blu_bounds, solve_table
from qcnn_gpu_tpu_torch.models import float_model as FM
from qcnn_gpu_tpu_torch.quant.params import QuantTable
from qcnn_gpu_tpu_torch.train.checkpoint import load_checkpoint


def _rel(a, b):
    return max(abs(x - y) / abs(y) for x, y in zip(a, b) if y)


def _moved_rows(t, ref):
    """Indices of the rows whose (mul, shift, blu_q) differ."""
    return [i for i, (r, q) in enumerate(zip(t, ref)) if (r.mul, r.shift, r.blu_q) != (q.mul, q.shift, q.blu_q)]


@pytest.mark.cuda
def test_full_float32_keeps_the_calibration_to_the_cpus(monkeypatch):
    """ckpt-1500 with scripts/train_demo.py's calibration sample (12 clean
    256x256 frames, DCT q=28, the first 4 anchors). Full float32 on the
    card: bounds within rtol 1e-6 of the CPU's (float32 summation order
    alone). TF32: further from the CPU's than full float32 is, by more
    than 1e-6 (TF32 keeps 10 mantissa bits)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the TF32 setting is cuDNN's")
    params, _, _ = load_checkpoint(T.asset("demo/ckpt"))
    sample = T.dct_compress(T.make_clean_frames(12, 256, 256), q=28.0)[:4]
    cpu = calibrate_blu_bounds(params, sample, device="cpu")
    fp32 = calibrate_blu_bounds(params, sample, device="cuda")

    @contextlib.contextmanager
    def tf32_convs():
        conv = torch.backends.cudnn.conv
        prev, conv.fp32_precision = conv.fp32_precision, "tf32"
        try:
            yield
        finally:
            conv.fp32_precision = prev

    monkeypatch.setattr(FM, "fp32_convs", tf32_convs)
    tf32 = calibrate_blu_bounds(params, sample, device="cuda")
    monkeypatch.undo()
    rel32, rel_tf32 = _rel(fp32, cpu), _rel(tf32, cpu)
    tables = {k: solve_table(params, blu_bounds=b) for k, b in (("cpu", cpu), ("fp32", fp32), ("tf32", tf32))}
    committed = QuantTable.load_pickle(T.asset("demo/quant_table.data"))
    print(f"\n{torch.cuda.get_device_name(0)}: calibration bounds on the card, max rel diff to the "
          f"CPU's: full float32 {rel32:.3e}, TF32 {rel_tf32:.3e}; rows whose (mul, shift, blu_q) "
          f"differ from the CPU's table: full float32 {_moved_rows(tables['fp32'], tables['cpu'])}, "
          f"TF32 {_moved_rows(tables['tf32'], tables['cpu'])}; the CPU's table against the committed "
          f"quant_table.data: {_moved_rows(tables['cpu'], committed)}; "
          f"blu_adj on the CPU {np.round(cpu, 6).tolist()}")
    assert rel32 <= 1e-6, rel32
    assert rel_tf32 > max(rel32, 1e-6), (rel_tf32, rel32)
