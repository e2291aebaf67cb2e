"""The wide CNN family, its GEMM route, tensor parallelism and sharded
training on a CUDA GPU: `_int_mm` and `_scaled_mm` at the shapes the
routes give them, against the plain versions on the same card. Run on the
card with `python -m pytest --noconftest -m cuda tests/test_torch_wide_cuda.py`;
without a GPU the tests skip. Imports no JAX module.

Tolerances: the INT8 routes 0; FP8 against its plain version at most 1
grey level (the card's FP8 tensor cores accumulate below float32
precision between cuBLASLt's float32 promotions: 1.5% of the pixels of
this test's c64 b3 frames read 1 off in the first run on an H100; the
CPU's `_scaled_mm` equals the plain version), and JAX's bounds against
the float model (PSNR above 40 dB, max |diff| at most 8); sharded
gradients within 1e-5 of each tensor's max |g|."""

import pytest
import torch

from qcnn_gpu_tpu_torch import testing as T
from qcnn_gpu_tpu_torch.data import datasets as D
from qcnn_gpu_tpu_torch.data.yuv import psnr
from qcnn_gpu_tpu_torch.models import float_model as FM
from qcnn_gpu_tpu_torch.models import wide as W
from qcnn_gpu_tpu_torch.models.qvrcnn import conv_exact, make_forward
from qcnn_gpu_tpu_torch.ops.int8_conv import conv_int8, gemm_operand
from qcnn_gpu_tpu_torch.parallel.mesh import make_mesh
from qcnn_gpu_tpu_torch.parallel.tensor import make_tp_int8_forward, make_tp_wide_forward
from qcnn_gpu_tpu_torch.testing import synth_engine_params, synth_frames
from qcnn_gpu_tpu_torch.train.trainer import make_grad_fn

# (frames, h, w, cin, cout, k, budget): K = 9, 25, 75; N = 1, 5, 6; M = 12;
# a budget that bands rows
CASES = [(2, 5, 7, 1, 16, 3, 1 << 30), (1, 9, 11, 3, 1, 5, 1 << 30), (3, 6, 8, 16, 8, 3, 2000),
         (1, 3, 4, 2, 5, 3, 1 << 30), (2, 40, 52, 64, 48, 5, 1 << 22), (1, 33, 47, 48, 6, 3, 1 << 30)]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch._int_mm and torch._scaled_mm on the card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES, ids=lambda c: "x".join(map(str, c[:6])))
def test_conv_int8_on_the_card_equals_conv_exact(dev, case):
    n, h, w, cin, cout, k, budget = case
    g = torch.Generator().manual_seed(sum(case[:6]))
    x = torch.randint(-128, 128, (n, h, w, cin), dtype=torch.int8, generator=g).to(dev)
    wt = torch.randint(-128, 128, (k, k, cin, cout), dtype=torch.int8, generator=g).to(dev)
    b = torch.randint(-9999, 9999, (cout,), dtype=torch.int32, generator=g).to(dev)
    got = conv_int8(x, gemm_operand(wt), b, budget=budget)
    want = conv_exact(x.permute(0, 3, 1, 2), wt, b).permute(0, 2, 3, 1)
    assert torch.equal(got.to(torch.int64), want)


@pytest.mark.cuda
def test_wide_forwards_on_the_card(dev):
    """INT8 == the plain version; FP8 within the tolerances above of its
    plain version and the float model; TP at tp 4 == the unsharded forward."""
    p = W.synth_wide_params(channels=64, blocks=3, seed=1)
    x = torch.from_numpy(synth_frames(2, 96, 128, seed=2)).to(dev)
    got = W.make_wide_forward(p, device=dev)(x)
    assert torch.equal(got, W.forward_wide(x, p))
    mesh = make_mesh(1, 4, devices=[dev] * 4)
    assert torch.equal(make_tp_wide_forward(p, mesh)(x), got)
    ws, bs = W.synth_float_wide(64, 3, seed=1)
    r8 = W.make_wide_forward_fp8(ws, bs, device=dev)(x)
    rp = W.make_wide_forward_fp8(ws, bs, device=dev, route="plain")(x)
    assert int((r8.to(torch.int16) - rp.to(torch.int16)).abs().max()) <= 1
    xn = (x[..., None].to(torch.float32) - 128.0) / 255.0
    with torch.no_grad():
        res = W.float_forward([torch.from_numpy(v).to(dev) for v in ws],
                              [torch.from_numpy(v).to(dev) for v in bs], xn)
    rec_f = torch.clamp(x.to(torch.float32) + torch.round(res[..., 0] * 255.0), 0, 255).to(torch.uint8)
    assert psnr(r8.cpu().numpy(), rec_f.cpu().numpy()) > 40.0
    assert int((r8.to(torch.int16) - rec_f.to(torch.int16)).abs().max()) <= 8


@pytest.mark.cuda
def test_tp_int8_on_the_card(dev):
    p = synth_engine_params(37)
    x = torch.from_numpy(synth_frames(2, 64, 96, seed=3)).to(dev)
    want = make_forward(p, device=dev)(x)
    for tp in (2, 8):
        assert torch.equal(make_tp_int8_forward(p, make_mesh(1, tp, devices=[dev] * tp))(x), want)


@pytest.mark.cuda
def test_sharded_gradients_on_the_card(dev):
    clean = T.make_clean_frames(2, 64, 96, seed=0)
    ds = D.PatchDataset([(clean, T.dct_compress(clean, q=28.0))], patch=32, seed=0)
    (x, y), = ds.batches(4, 1)
    params = FM.params_from_jax(FM.init_params(3), dev)
    loss1, g1 = make_grad_fn(make_mesh(1, 1, devices=[dev]))(params, x, y)
    loss, g = make_grad_fn(make_mesh(2, 2, devices=[dev] * 4))(params, x, y)
    assert float(loss) == pytest.approx(float(loss1), rel=1e-5)
    for k in FM.PARAM_NAMES:
        assert float((g[k] - g1[k]).abs().max()) <= 1e-5 * float(g1[k].abs().max()), k
