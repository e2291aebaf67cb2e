"""A hidden layer's one-pass bias add and BLU requant
(`ops/requant.bias_blu_requant_i8`, the CUDA kernel
`csrc/requant_epilogue.cu`) on the CPU: its plain version against the
int64 `blu_requant_i32(u + b, ...)`, the layout it reads, the path it
chooses, what it refuses, and how `models/wide.make_wide_forward` calls it.
The kernel itself runs on the card (tests/test_torch_wide_cuda.py).

Tolerance: 0 everywhere (integer arithmetic)."""

import os
import re

import pytest
import torch

from qcnn_gpu_tpu_torch.models import wide as W
from qcnn_gpu_tpu_torch.ops import requant as R
from qcnn_gpu_tpu_torch.testing import synth_frames

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(REPO, "qcnn_gpu_tpu_torch", "csrc", "requant_epilogue.cu")
# (blu_q, mul, shift): a solved wide layer's row, and one at the int32
# envelope's edge: (blu_q + rb) * mul = 2,147,483,640, 8 below 2^31
ENVELOPE = (130568, 16383, 24)
TABLES = {"solved": W.int32_table(W.synth_wide_params(channels=16, blocks=2, seed=1))[1],
          "envelope": ENVELOPE}
INT32_MAX = (1 << 31) - 1


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def edge_inputs(c: int, blu_q, seed: int):
    """Accumulators [2, 3, 5, c] and a bias [c] whose sums v = u + b take,
    channel by channel, the values -1, 0, blu_q, blu_q + 1, the largest and
    smallest int32 that the add reaches without wrapping, and seeded values
    around [0, blu_q]."""
    g = torch.Generator().manual_seed(seed)
    b = torch.randint(-(1 << 20), 1 << 20, (c,), dtype=torch.int32, generator=g)
    q = blu_q.to(torch.int64) if isinstance(blu_q, torch.Tensor) else torch.full((c,), blu_q)
    hi = int(q.max())
    v = torch.randint(-hi // 4, hi + hi // 4 + 2, (2, 3, 5, c), dtype=torch.int64, generator=g)
    v[0, 0, 0], v[0, 0, 1], v[0, 0, 2], v[0, 0, 3] = -1, 0, q, q + 1
    v[0, 0, 4], v[0, 1, 0] = INT32_MAX - (1 << 20), -INT32_MAX + (1 << 20)
    return (v - b.to(torch.int64)).to(torch.int32), b


def per_channel(c: int):
    """[c] int32 rows cycling through TABLES and the solved wide table."""
    rows = list(TABLES.values()) + W.int32_table(W.synth_wide_params(channels=16, blocks=3, seed=4))
    pick = [rows[i % len(rows)] for i in range(c)]
    return tuple(torch.tensor([r[k] for r in pick], dtype=torch.int32) for k in range(3))


@pytest.mark.parametrize("c", [16, 20, 3])
@pytest.mark.parametrize("table", ["solved", "envelope", "per-channel"])
def test_plain_version_equals_blu_requant_i32(table, c):
    rows = per_channel(c) if table == "per-channel" else TABLES[table]
    u, b = edge_inputs(c, rows[0], seed=c)
    got = R.bias_blu_requant_i8(u, b, *rows)
    want = R.blu_requant_i32(u + b, *rows)
    assert got.dtype == torch.int8 and got.shape == u.shape and got.is_contiguous()
    assert torch.equal(got.to(torch.int32), want)
    assert int(got.min()) == 0 and int(got.max()) == 127


@pytest.mark.parametrize("table", ["solved", "per-channel"])
def test_plain_version_reads_a_padded_n_view(table):
    """The GEMM route hands over `[..., :cout]` of an Np-wide matrix."""
    cout, np_ = 20, 24
    rows = per_channel(cout) if table == "per-channel" else TABLES[table]
    u, b = edge_inputs(cout, rows[0], seed=5)
    full = torch.full(u.shape[:-1] + (np_,), INT32_MAX, dtype=torch.int32)
    full[..., :cout] = u
    view = full[..., :cout]
    assert R.row_stride(view) == np_ and not view.is_contiguous()
    got = R.bias_blu_requant_i8(view, b, *rows)
    assert got.is_contiguous() and torch.equal(got.to(torch.int32), R.blu_requant_i32(u + b, *rows))


def test_row_stride_of_the_layouts_it_takes_and_refuses():
    x = torch.zeros(2, 3, 4, 8, dtype=torch.int32)
    assert R.row_stride(x) == 8
    assert R.row_stride(torch.zeros(2, 3, 4, 16, dtype=torch.int32)[..., :8]) == 16
    assert R.row_stride(torch.zeros(5, dtype=torch.int32)) == 5
    assert R.row_stride(torch.zeros(1, 1, 6, 24, dtype=torch.int32)[..., 4:12]) == 24
    assert R.row_stride(torch.zeros(1, 1, 1, 8, dtype=torch.int32)) == 8
    for bad in (x.transpose(-1, -2), x[:, ::2], x.transpose(1, 2),
                torch.zeros(4, 8, dtype=torch.int32).as_strided((4, 8), (4, 1))):
        with pytest.raises(ValueError):
            R.row_stride(bad)


@pytest.mark.parametrize("c, ld, u_ptr, out_ptr, vec", [
    (256, 256, 0, 0, True), (48, 48, 64, 16, True), (256, 264, 0, 0, True),
    (20, 24, 0, 0, False), (3, 8, 0, 0, False), (256, 258, 0, 0, False),
    (256, 256, 4, 0, False), (256, 256, 0, 8, False), (16 * 257, 16 * 257, 0, 0, False)])
def test_vector_path_from_the_shape_and_the_pointers(c, ld, u_ptr, out_ptr, vec):
    assert R.vector_path(c, ld, u_ptr, out_ptr) is vec


def test_wrapper_refuses_what_the_kernel_does_not_take():
    u, b = edge_inputs(16, 100, seed=1)
    row = TABLES["solved"]
    with pytest.raises(TypeError):
        R.bias_blu_requant_i8(u.to(torch.int64), b, *row)
    with pytest.raises(TypeError):
        R.bias_blu_requant_i8(u, b.to(torch.int64), *row)
    for bias in (b[:15], torch.stack([b, b], 1)[:, 0]):
        with pytest.raises(ValueError):
            R.bias_blu_requant_i8(u, bias, *row)
    with pytest.raises(ValueError):
        R.bias_blu_requant_i8(u[..., :15], b, *row)
    q, m, s = per_channel(16)
    for rows in ((q[:8], m[:8], s[:8]), (q, m, int(s[0])), (q.to(torch.int64), m, s),
                 (q[::2].repeat(2), m, torch.stack([s, s], 1)[:, 0])):
        with pytest.raises(ValueError):
            R.bias_blu_requant_i8(u, b, *rows)
    with pytest.raises(ValueError):
        R.bias_blu_requant_i8(u.transpose(1, 2), b, *row)
    with pytest.raises(ValueError):
        R.bias_blu_requant_i8(u.to("meta"), b.to("meta"), *row)
    R.bias_blu_requant_i8.launches = 0
    R.bias_blu_requant_i8(u, b, *row)
    assert R.bias_blu_requant_i8.launches == 0  # the plain version launches nothing


def test_source_matches_the_wrapper_and_stays_out_of_the_traces_other_kinds():
    """The kernel's block and group are the wrapper's, and its entries are
    named neither like a GEMM nor like a network kernel, so the benchmark's
    trace counts them as epilogue kernels."""
    from benchmark import trace

    with open(SOURCE) as fp:
        src = fp.read()
    assert re.search(rf"constexpr int THREADS = {R.THREADS};", src)
    assert re.search(rf"constexpr int GROUP = {R.VECTOR};", src)
    kernels = re.findall(r"__global__ void __launch_bounds__\(THREADS\)\s+(\w+)\(", src)
    assert kernels == ["bias_blu_requant_vec", "bias_blu_requant_elem"]
    for name in kernels:
        assert trace.kind(f"void (anonymous namespace)::{name}<true>(int const*, long long, "
                          "signed char*, long long, int, int const*, int const*, int const*, "
                          "int const*, int, int, int)") == "kernel"
    assert '#include "' not in src  # standalone: cuda_runtime.h and <cstdint> only


def test_wide_forward_calls_it_once_a_hidden_layer_and_chunk(monkeypatch):
    """c16 b2, 3 frames in chunks of one: 3 hidden layers x 3 chunks
    calls, each on a layer's bias-free accumulators, and the result exact."""
    p = W.synth_wide_params(channels=16, blocks=2, seed=1)
    x = torch.from_numpy(synth_frames(3, 12, 16, seed=2))
    calls = []
    wrapper = W.bias_blu_requant_i8

    def counted(u, b, *rows):
        calls.append((u.dtype, tuple(u.shape), b.shape[0]))
        return wrapper(u, b, *rows)

    monkeypatch.setattr(W, "bias_blu_requant_i8", counted)
    monkeypatch.setattr(W, "frames_per_chunk", lambda *a, **k: 1)
    got = W.make_wide_forward(p, device="cpu", route="gemm")(x)
    assert calls == [(torch.int32, (1, 12, 16, 16), 16)] * (3 * (len(p.weights) - 1))
    assert torch.equal(got, W.forward_wide(x, p))
