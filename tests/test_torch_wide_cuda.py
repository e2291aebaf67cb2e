"""The wide CNN family, its GEMM route, tensor parallelism and sharded
training on a CUDA GPU: `_int_mm` and `_scaled_mm` at the shapes the
routes give them, and the hidden layers' one-pass epilogue (the kernel
`csrc/requant_epilogue.cu`), against the plain versions on the same card. Run on the
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
from qcnn_gpu_tpu_torch.ops import requant as R
from qcnn_gpu_tpu_torch.ops.int8_conv import conv_int8, gemm_operand
from qcnn_gpu_tpu_torch.parallel.mesh import make_mesh
from qcnn_gpu_tpu_torch.parallel.tensor import make_tp_int8_forward, make_tp_wide_forward
from qcnn_gpu_tpu_torch.testing import synth_engine_params, synth_frames
from qcnn_gpu_tpu_torch.train.trainer import make_grad_fn

# (frames, h, w, cin, cout, k, budget): K = 9, 25, 75; N = 1, 5, 6; M = 12;
# a budget that bands rows
CASES = [(2, 5, 7, 1, 16, 3, 1 << 30), (1, 9, 11, 3, 1, 5, 1 << 30), (3, 6, 8, 16, 8, 3, 2000),
         (1, 3, 4, 2, 5, 3, 1 << 30), (2, 40, 52, 64, 48, 5, 1 << 22), (1, 33, 47, 48, 6, 3, 1 << 30)]


# the requant epilogue: (C, ld, M, column offset, vector path): the cell's
# width and QVRCNN's 48 on the vector path, 20 and 3 on the element path,
# padded-N strides, a misaligned view of a 16-channel matrix, and M no
# multiple of a block's rows (16 at C = 256, 85 at 48)
EPILOGUE_CASES = [(256, 256, 4099, 0, True), (48, 48, 1001, 0, True), (256, 264, 333, 0, True),
                  (48, 64, 256, 0, True), (20, 24, 777, 0, False), (3, 8, 301, 0, False),
                  (16, 32, 500, 1, False)]
# (blu_q, mul, shift): a solved wide layer's row and one at the int32
# envelope's edge ((blu_q + rb) * mul = 2,147,483,640)
EPILOGUE_TABLES = [W.int32_table(W.synth_wide_params(channels=16, blocks=2, seed=1))[1],
                   (130568, 16383, 24)]


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


@pytest.mark.cuda
@pytest.mark.parametrize("per_channel", [False, True], ids=["layer", "channel"])
@pytest.mark.parametrize("case", EPILOGUE_CASES, ids=lambda c: "x".join(map(str, c[:4])))
def test_requant_epilogue_kernel_equals_its_plain_version(dev, case, per_channel):
    """Bit-equal to `blu_requant_clamped_i32(u + b, ...)` on the card and to
    the int64 `blu_requant_i32`, with v = u + b at -1, 0, blu_q, blu_q + 1
    and near both int32 ends in the first rows, seeded values elsewhere."""
    c, ld, m, off, vec = case
    g = torch.Generator().manual_seed(c * 7 + ld + m)
    if per_channel:
        pick = [EPILOGUE_TABLES[i % 2] for i in range(c)]
        rows = tuple(torch.tensor([r[k] for r in pick], dtype=torch.int32) for k in range(3))
        q = rows[0].to(torch.int64)
    else:
        rows = EPILOGUE_TABLES[(c + m) % 2]
        q = torch.full((c,), rows[0], dtype=torch.int64)
    b = torch.randint(-(1 << 20), 1 << 20, (c,), dtype=torch.int32, generator=g)
    hi = int(q.max())
    v = torch.randint(-hi // 4, hi + hi // 4 + 2, (m, c), dtype=torch.int64, generator=g)
    v[0], v[1], v[2], v[3] = -1, 0, q, q + 1
    v[4], v[5] = (1 << 31) - 1 - (1 << 20), -(1 << 31) + (1 << 20)
    full = torch.randint(-9, 9, (m, ld + off), dtype=torch.int32, generator=g)
    full[:, off:off + c] = (v - b.to(torch.int64)).to(torch.int32)
    u = full.to(dev)[:, off:off + c]
    bd = b.to(dev)
    rows_dev = tuple(r.to(dev) for r in rows) if per_channel else rows
    out_probe = torch.empty((m, c), dtype=torch.int8, device=dev)
    assert R.vector_path(c, R.row_stride(u), u.data_ptr(), out_probe.data_ptr()) is vec
    R.bias_blu_requant_i8.launches = 0
    got = R.bias_blu_requant_i8(u, bd, *rows_dev)
    torch.cuda.synchronize()
    assert R.bias_blu_requant_i8.launches == 1
    assert got.dtype == torch.int8 and got.shape == (m, c) and got.is_contiguous()
    assert torch.equal(got, R.blu_requant_clamped_i32(u + bd, *rows_dev))
    assert torch.equal(got.to(torch.int32), R.blu_requant_i32(u + bd, *rows_dev))
    batched = R.bias_blu_requant_i8(u.unflatten(0, (1, m)), bd, *rows_dev)
    assert torch.equal(batched[0], got)


@pytest.mark.cuda
def test_wide_forward_launches_the_epilogue_once_a_hidden_layer_and_chunk(dev, monkeypatch):
    """c32 b3 on 3 frames in chunks of 2: the kernel runs (hidden layers)
    x (chunks) times, `_int_mm` (layers) x (chunks) times (one band each),
    and the result equals the plain version."""
    p = W.synth_wide_params(channels=32, blocks=3, seed=5)
    x = torch.from_numpy(synth_frames(3, 40, 48, seed=6)).to(dev)
    monkeypatch.setattr(W, "frames_per_chunk", lambda *a, **k: 2)
    run = W.make_wide_forward(p, device=dev)
    conv_int8.launches = R.bias_blu_requant_i8.launches = 0
    got = run(x)
    torch.cuda.synchronize()
    assert R.bias_blu_requant_i8.launches == (len(p.weights) - 1) * 2
    assert conv_int8.launches == len(p.weights) * 2
    assert torch.equal(got, W.forward_wide(x, p))
