"""The port's wide CNN family (models/wide.py) and its GEMM convolution
route (ops/int8_conv.py) on the CPU, against the JAX package's
`models/wide.py` on the same seeded numpy inputs.

Tolerances:
  * parameters, tables, npz files and fp8 weight bytes: 0;
  * the INT8 forwards (the plain version, and the card's GEMM route run
    explicitly on the CPU): 0, against JAX's numpy oracle and XLA forward;
  * the GEMM route's convolution: 0 against `conv_exact`;
  * `float_forward` and its gradient: within 1e-5 of each tensor's max
    |value| (float32 sums in another order);
  * the FP8 forward against JAX's: at most 1 grey level, on at most 0.1%
    of the pixels (float32 sums in another order can move a residual
    across a rounding edge); against the float model, JAX's own bounds
    (tests/test_wide.py): PSNR above 40 dB, max |diff| at most 8."""

import functools
import weakref

import numpy as np
import pytest
import torch

from qcnn_gpu_tpu.models import wide as JW
from qcnn_gpu_tpu_torch import spans
from qcnn_gpu_tpu_torch.data import yuv
from qcnn_gpu_tpu_torch.models import wide as W
from qcnn_gpu_tpu_torch.models.qvrcnn import conv_exact
from qcnn_gpu_tpu_torch.ops.int8_conv import conv_fp8, conv_int8, gemm_operand
from qcnn_gpu_tpu_torch.parallel.mesh import make_mesh
from qcnn_gpu_tpu_torch.parallel.tensor import make_tp_wide_forward
from qcnn_gpu_tpu_torch.testing import synth_frames


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """These tests run small tensors: one intra-op thread each keeps them
    off the cores the other test workers use."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def assert_params_equal(mine: W.WideParams, theirs):
    for a, b in zip(mine.weights + mine.biases, theirs.weights + theirs.biases, strict=True):
        assert a.dtype == b.dtype and a.shape == b.shape and (a == b).all()
    assert (mine.blu_q, mine.mul, mine.shift) == (theirs.blu_q, theirs.mul, theirs.shift)
    assert (mine.mul_last, mine.shift_last) == (theirs.mul_last, theirs.shift_last)


@pytest.mark.parametrize("seed", [1, 2, 4])
def test_synth_wide_params_equal_jax(seed):
    mine = W.synth_wide_params(channels=32, blocks=3, seed=seed)
    assert_params_equal(mine, JW.synth_wide_params(channels=32, blocks=3, seed=seed))
    for blu_q, mul, shift in zip(mine.blu_q, mine.mul, mine.shift):
        assert 126.0 < blu_q * mul / 2.0**shift <= 127.5 and shift <= 24


def test_npz_files_cross_the_packages(tmp_path):
    mine = W.synth_wide_params(channels=16, blocks=2, seed=4)
    theirs = JW.synth_wide_params(channels=16, blocks=2, seed=4)
    mine.save(str(tmp_path / "port.npz"))
    theirs.save(str(tmp_path / "jax.npz"))
    assert_params_equal(W.WideParams.load(str(tmp_path / "jax.npz")), theirs)
    back = JW.WideParams.load(str(tmp_path / "port.npz"))
    assert_params_equal(mine, back)
    assert back.channels == 16 and back.blocks == 2


@pytest.mark.parametrize("route", ["plain", "gemm"])
def test_wide_forward_equals_jax(route):
    """c32 b2 on 2 frames of 24x32: the plain version (the CPU default)
    and the card's GEMM route equal JAX's oracle and XLA forward."""
    p = W.synth_wide_params(channels=32, blocks=2, seed=2)
    jp = JW.synth_wide_params(channels=32, blocks=2, seed=2)
    x = synth_frames(2, 24, 32, seed=3)
    want = JW.forward_wide(x, jp)
    assert (np.asarray(JW.make_wide_forward(jp)(x)) == want).all()
    run = W.make_wide_forward(p, device="cpu", route=None if route == "plain" else route)
    assert run.impl == "wide-int" and run.route == route
    assert (run(torch.from_numpy(x)).numpy() == want).all()


# (frames, h, w, cin, cout, k, budget): K = 9 and 75 (no multiple of 8),
# N = 1 and 5, M = 12 (<= 16), a budget that bands rows, and im2col copies
# of bytes (cin 1, 3), 2-byte (cin 2), 4-byte (cin 12) and 8-byte words
CONV_CASES = [(2, 5, 7, 1, 16, 3, 1 << 30), (1, 9, 11, 3, 1, 5, 1 << 30),
              (3, 6, 8, 16, 8, 3, 2000), (1, 3, 4, 2, 5, 3, 1 << 30),
              (2, 13, 9, 24, 24, 3, 9 * 1000), (1, 6, 5, 12, 9, 3, 1 << 30)]


@pytest.mark.parametrize("case", CONV_CASES, ids=lambda c: "x".join(map(str, c[:6])))
def test_conv_int8_gemm_route_equals_conv_exact(case):
    n, h, w, cin, cout, k, budget = case
    g = torch.Generator().manual_seed(sum(case[:6]))
    x = torch.randint(-128, 128, (n, h, w, cin), dtype=torch.int8, generator=g)
    wt = torch.randint(-128, 128, (k, k, cin, cout), dtype=torch.int8, generator=g)
    b = torch.randint(-9999, 9999, (cout,), dtype=torch.int32, generator=g)
    want = conv_exact(x.permute(0, 3, 1, 2), wt, b).permute(0, 2, 3, 1)
    conv_int8.launches = 0
    got = conv_int8(x, gemm_operand(wt), b, route="gemm", budget=budget)
    assert got.dtype == torch.int32 and torch.equal(got.to(torch.int64), want)
    assert conv_int8.launches >= (2 if budget < 1 << 20 else 1)
    assert torch.equal(conv_int8(x, wt, b), got)  # the CPU default: the plain version


def test_part_hook_marks_each_part_of_each_layer():
    """The parts that tools/bench_wide.route_split splits the forward by,
    once the timing hook, are program spans (spans.py): under a profiler
    the GEMM route of make_wide_forward records the input's centring once,
    each layer's pad and tap copy and its GEMM (one band each at this
    size), then every hidden layer's bias and requant in one span, and the
    tail's bias and residual, in that order, and leaves the result exact."""
    p = W.synth_wide_params(channels=16, blocks=2, seed=1)
    x = torch.from_numpy(synth_frames(1, 12, 16, seed=2))
    run = W.make_wide_forward(p, device="cpu", route="gemm")
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        got = run(x)
    seen = [name for name, _, _, _ in sorted(spans.read_profiler(prof)[0], key=lambda sp: sp[2])]
    layer = [spans.CONV_IM2COL, spans.CONV_IM2COL, spans.CONV_GEMM]
    n = len(p.weights)
    assert seen == ([spans.WIDE_INPUT] + (layer + [spans.WIDE_REQUANT]) * (n - 1) + layer
                    + [spans.CONV_BIAS, spans.WIDE_RESIDUAL])
    assert torch.equal(got, W.forward_wide(x, p))


def test_gemm_forward_frees_each_layers_accumulators(monkeypatch):
    """When a layer's convolution starts, no earlier layer's int32
    accumulators are alive: at 832x480 and 256 channels each is 409 MB a
    frame, and one kept a layer longer raises the card's peak by that."""
    p = W.synth_wide_params(channels=16, blocks=3, seed=1)
    x = torch.from_numpy(synth_frames(2, 12, 16, seed=2))
    outs, alive = [], []
    conv = W.conv_int8

    def tracked(*a, **k):
        alive.append(sum(r() is not None for r in outs))
        u = conv(*a, **k)
        outs.append(weakref.ref(u))
        return u

    monkeypatch.setattr(W, "conv_int8", tracked)
    got = W.make_wide_forward(p, device="cpu", route="gemm")(x)
    assert len(alive) == len(p.weights) and alive == [0] * len(alive)
    assert torch.equal(got, W.forward_wide(x, p))


def test_conv_fp8_gemm_route_equals_float32_conv():
    """fp8 products are exact in float32: the `_scaled_mm` route equals a
    float32 conv of the same values up to float32 summation order."""
    g = torch.Generator().manual_seed(0)
    x = (torch.rand((2, 7, 9, 16), generator=g) * 400).to(torch.float8_e4m3fn)
    wt = (torch.randn((3, 3, 16, 3), generator=g) * 100).to(torch.float8_e4m3fn)
    got = conv_fp8(x, gemm_operand(wt, align=16), budget=3000)
    want = torch.nn.functional.conv2d(x.float().permute(0, 3, 1, 2),
                                      wt.float().permute(3, 2, 0, 1), padding=1)
    want = want.permute(0, 2, 3, 1)
    assert got.shape == want.shape
    assert (got - want).abs().max() <= 1e-6 * want.abs().max()


def test_float_forward_and_gradient_equal_jax():
    import jax
    import jax.numpy as jnp

    ws, bs = W.synth_float_wide(16, 2, seed=3)
    x = synth_frames(2, 24, 32, seed=4)
    xn = (x[..., None].astype(np.float32) - 128.0) / 255.0
    y = np.random.default_rng(5).normal(0, 0.02, xn.shape).astype(np.float32)

    def jloss(params):
        return jnp.sum((JW.float_forward(*params, jnp.asarray(xn)) - y) ** 2)

    jparams = ([jnp.asarray(w) for w in ws], [jnp.asarray(b) for b in bs])
    jres = np.asarray(JW.float_forward(*jparams, jnp.asarray(xn)))
    jgrads = jax.grad(jloss)(jparams)
    tws = [torch.from_numpy(w).requires_grad_() for w in ws]
    tbs = [torch.from_numpy(b).requires_grad_() for b in bs]
    res = W.float_forward(tws, tbs, torch.from_numpy(xn))
    assert np.abs(res.detach().numpy() - jres).max() <= 1e-5 * np.abs(jres).max()
    torch.sum((res - torch.from_numpy(y)) ** 2).backward()
    for t, g in zip(tws + tbs, list(jgrads[0]) + list(jgrads[1])):
        g = np.asarray(g)
        assert np.abs(t.grad.numpy() - g).max() <= 1e-5 * np.abs(g).max()


def test_fp8_weight_bytes_equal_jax():
    ws, bs = W.synth_float_wide(32, 2, seed=5)
    w8, scales = W.quantize_wide_fp8(ws, bs)
    jw8, jscales = JW.quantize_wide_fp8(ws, bs)
    for a, b, s, js in zip(w8, jw8, scales, jscales, strict=True):
        assert a.dtype == torch.float8_e4m3fn
        assert np.array_equal(a.view(torch.uint8).numpy(), np.asarray(b).view(np.uint8))
        assert np.array_equal(s.numpy(), np.asarray(js))


@functools.lru_cache(maxsize=None)
def _fp8_case():
    """JAX's FP8 test case (c32 b2, 2 frames of 40x56): (ws, bs, frames,
    JAX's FP8 output)."""
    import jax.numpy as jnp

    rng = np.random.default_rng(5)
    shapes = [(3, 3, 1, 32)] + [(3, 3, 32, 32)] * 2 + [(3, 3, 32, 1)]
    ws = [rng.normal(0, 0.6 / np.sqrt(s[0] * s[1] * s[2]), s).astype(np.float32) for s in shapes]
    bs = [rng.normal(0, 0.01, s[3]).astype(np.float32) for s in shapes]
    x = synth_frames(2, 40, 56, seed=9)
    return ws, bs, x, np.asarray(JW.make_wide_forward_fp8(ws, bs)(jnp.asarray(x)))


@pytest.mark.parametrize("route", ["plain", "gemm"])
def test_fp8_forward_against_jax_and_the_float_model(route):
    """The port's FP8 forward on JAX's FP8 test case against JAX's and
    against the float model, within the tolerances above; 1 B of weights
    per parameter."""
    ws, bs, x, jrec = _fp8_case()
    run = W.make_wide_forward_fp8(ws, bs, device="cpu", route=None if route == "plain" else route)
    assert run.impl == "wide-fp8" and run.route == route
    rec = run(torch.from_numpy(x)).numpy()
    assert rec.shape == x.shape and rec.dtype == np.uint8
    diff = np.abs(rec.astype(int) - jrec.astype(int))
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3
    xn = torch.from_numpy((x[..., None].astype(np.float32) - 128.0) / 255.0)
    res_f = W.float_forward([torch.from_numpy(w) for w in ws], [torch.from_numpy(b) for b in bs],
                            xn).numpy()
    rec_f = np.clip(x.astype(np.float32) + np.round(res_f[..., 0] * 255.0), 0, 255).astype(np.uint8)
    assert yuv.psnr(rec, rec_f) > 40.0
    assert np.abs(rec.astype(int) - rec_f.astype(int)).max() <= 8
    assert run.weight_bytes == sum(w.size for w in ws)


def test_train_quantize_engine_oracle_tp_loop():
    """tests/test_wide.py:67's closed loop, trained with torch: Adam on the
    float twin lowers the loss; quantize_wide of the result; the port's
    INT8 forward == JAX's oracle == the port's TP forward at tp 4."""
    channels, blocks = 16, 2
    rng = np.random.default_rng(11)
    shapes = [(3, 3, 1, channels)] + [(3, 3, channels, channels)] * blocks + [(3, 3, channels, 1)]
    ws = [torch.tensor(rng.normal(0, 0.6 / np.sqrt(s[0] * s[1] * s[2]), s), dtype=torch.float32,
                       requires_grad=True) for s in shapes]
    bs = [torch.zeros(s[3], requires_grad=True) for s in shapes]
    clean = synth_frames(8, 32, 32, seed=12).astype(np.float32)
    noisy = np.clip(clean + rng.normal(0, 6, clean.shape), 0, 255).astype(np.float32)
    xn = torch.from_numpy((noisy - 128.0) / 255.0)[..., None]
    tgt = torch.from_numpy((clean - 128.0) / 255.0)[..., None]
    opt = torch.optim.Adam(ws + bs, lr=1e-3, betas=(0.9, 0.999), eps=1e-8)
    losses = []
    for _ in range(25):
        opt.zero_grad()
        loss = torch.mean((W.float_forward(ws, bs, xn) + xn - tgt) ** 2)
        loss.backward()
        opt.step()
        losses.append(loss.item())
    assert losses[-1] < losses[0]
    ws_f = [w.detach().numpy() for w in ws]
    bs_f = [b.detach().numpy() for b in bs]
    blu = [2.0] * (blocks + 1) + [0.0]
    p = W.quantize_wide(ws_f, bs_f, blu=blu)
    assert_params_equal(p, JW.quantize_wide(ws_f, bs_f, blu=blu))
    x = synth_frames(1, 24, 32, seed=13)
    rec = W.make_wide_forward(p, device="cpu", route="gemm")(torch.from_numpy(x)).numpy()
    assert (rec == JW.forward_wide(x, JW.quantize_wide(ws_f, bs_f, blu=blu))).all()
    tp = make_tp_wide_forward(p, make_mesh(1, 4, devices=[torch.device("cpu")] * 4))
    assert (tp(torch.from_numpy(x)).numpy() == rec).all()


def test_make_wide_forward_refuses_what_it_cannot_run():
    """A table whose (blu_q + bias) * mul reaches 2^31 (possible in a file,
    never from the solver); an unknown route; a CUDA device without one."""
    p = W.synth_wide_params(channels=8, blocks=1, seed=0)
    bad = W.WideParams(p.weights, p.biases, [2**28] + p.blu_q[1:], p.mul, p.shift,
                       p.mul_last, p.shift_last)
    with pytest.raises(ValueError, match="wide layer 0"):
        W.make_wide_forward(bad, device="cpu")
    with pytest.raises(ValueError, match="route"):
        W.make_wide_forward(p, device="cpu", route="xla")
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            W.make_wide_forward(p, device="cuda")
