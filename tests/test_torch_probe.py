"""The matrix-rate probe (qcnn_gpu_tpu_torch/tools/mma_probe.py).

On the CPU: the chain's plain version `mma_probe_reference` equal to the
Pallas probe of `scripts/mfu_probe.py`, loaded by path and run in
interpret mode at M=64, GRID=2 (its module globals `M`, `GRID` and `pl`
replaced for the run; nothing in scripts/ changes), on the int8, bf16 and
f32 cases, against the last block's slot, which is the TPU's whole result;
the kernel's s prologue (`chain_scalars`, from row 0 of a and column 0 of
the w's) equal to the s that the full plain chain records, on every case
and on a seed whose row-0 sum goes below 0; the B layout the kernel reads
(`kernel_operand`); the issue-rate kernel's plain version. On a GPU
(skipped here): both kernels equal to their plain versions, at grid 2 and,
for the timed shapes and the negative-sum seed, at one block per SM.
Tolerance: 0 (integer-valued operands, every sum exact).

No JAX module is imported at the top of this file, so that the CUDA test
also runs on a GPU machine without jax:
`python -m pytest --noconftest -m cuda tests/test_torch_probe.py`."""

import functools
import importlib.util
import os

import numpy as np
import pytest
import torch

from qcnn_gpu_tpu_torch.tools import mma_probe as P

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
M, GRID = 64, 2


@pytest.fixture(scope="module")
def jax_probe():
    """scripts/mfu_probe.py as a module, with M, GRID and an interpreting `pl`."""
    from types import SimpleNamespace

    from jax.experimental import pallas as pl

    spec = importlib.util.spec_from_file_location(
        "mfu_probe_under_test", os.path.join(REPO, "scripts", "mfu_probe.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.M, mod.GRID = M, GRID
    mod.pl = SimpleNamespace(BlockSpec=pl.BlockSpec,
                             pallas_call=functools.partial(pl.pallas_call, interpret=True))
    return mod


@pytest.mark.parametrize("name,kind,k,n", [c for c in P.CASES if c[0] in (
    "int8_i32", "bf16_f32", "f32_f32", "int8_k96_n8")])
def test_plain_matches_pallas_probe(jax_probe, name, kind, k, n):
    import jax.numpy as jnp

    a, w = P.probe_inputs(kind, k, n, grid=GRID, m=M, seed=1, device="cpu")
    jdt = {"int8": jnp.int8, "bf16": jnp.bfloat16, "f32": jnp.float32}[kind]
    acc = jnp.int32 if kind == "int8" else jnp.float32
    run = jax_probe.build(acc, n=n, k=k)
    want = np.asarray(run(jnp.asarray(a.float().numpy(), dtype=jdt),
                          jnp.asarray(w.float().numpy(), dtype=jdt)))
    got = P.mma_probe(a, w)  # CPU tensors: the plain version
    assert got.shape == (GRID, M, n) and got.dtype == P.TYPES[kind][1]
    assert (got[-1].numpy() == want).all()
    assert not (got[0] == got[-1]).all()  # each block has its own slot


def test_chain_depends_on_the_previous_step():
    """s moves the int8 weights: a chain without it differs."""
    a, w = P.probe_inputs("int8", 32, 8, grid=1, m=32, device="cpu")
    got = P.mma_probe_reference(a, w)
    flat = sum(torch.bmm(a.double(), w[c].double()[None]) for c in range(P.CHAIN))
    assert not torch.equal(got, flat.to(torch.int32))


def test_issue_plain_version_and_counts():
    for kind, k in P.ISSUE_K.items():
        ref = P.mma_issue(kind, 3, iters=5, device="cpu")
        assert ref.shape == (3 * P.ISSUE_THREADS,)
        assert (ref == 4 * P.NACC * 5 * k).all()
        assert P.issue_macs(kind, 3, 5) == 3 * 8 * P.NACC * 5 * 16 * 8 * k
    with pytest.raises(ValueError, match="no issue-rate kernel"):
        P.mma_issue("f32", 1, device="cpu")


def test_wrapper_checks_inputs():
    a, w = P.probe_inputs("int8", 96, 8, grid=1, m=32, device="cpu")
    with pytest.raises(ValueError, match="expected a"):
        P.mma_probe(a, w[:3])
    with pytest.raises(ValueError, match="share type"):
        P.mma_probe(a, w.to(torch.bfloat16))
    assert P.kernel_operand(w).shape == (P.CHAIN, 6, 8, 16)  # 16-byte planes of K
    assert P.macs(a, w) == 32 * 96 * 8 * P.CHAIN


CHAIN_CASES = [c[1:] + (0,) for c in P.CASES] + [("int8", 128, 128, P.NEGATIVE_SEED)]


@pytest.mark.parametrize("kind,k,n,seed", CHAIN_CASES)
def test_chain_scalars_match_plain_chain(kind, k, n, seed):
    """The kernel's prologue, plain: the s of every step from row 0 of a
    and column 0 of the w's, equal to the s the full chain records."""
    torch.set_num_threads(1)
    a, w = P.probe_inputs(kind, k, n, grid=GRID, m=M, seed=seed, device="cpu")
    acc_dt = P.TYPES[kind][1]
    # the full chain over all M rows, as mma_probe_reference runs it, with
    # the s of each step recorded
    acc = torch.zeros((GRID, M, n), dtype=acc_dt)
    s = torch.zeros(GRID, dtype=acc_dt)
    want = []
    for c in range(P.CHAIN):
        want.append(s)
        wc = (w[c].to(acc_dt)[None] + s[:, None, None]).to(w.dtype)
        acc = acc + torch.bmm(a.double(), wc.double()).to(acc_dt)
        s = P._derive(acc[:, 0, 0], kind)
    assert torch.equal(acc, P.mma_probe_reference(a, w))
    got, sums = P.chain_scalars(a[:, 0], w)
    assert got.shape == sums.shape == (GRID, P.CHAIN) and got.dtype == acc_dt
    assert torch.equal(got, torch.stack(want, 1))
    assert torch.equal(sums[:, -1], acc[:, 0, 0])


def test_negative_seed_takes_pythons_sign():
    """At NEGATIVE_SEED block 0's acc[0, 0] goes below 0 with a remainder,
    where % 3 must give s in [0, 2] (C's % would give a negative s)."""
    a, w = P.probe_inputs("int8", 128, 128, grid=1, m=1, seed=P.NEGATIVE_SEED, device="cpu")
    s, sums = P.chain_scalars(a[:, 0], w)
    neg = (sums[0] < 0) & (torch.fmod(sums[0], 3) != 0)
    assert neg.any() and (sums[0] > 0).any()
    assert ((s >= 0) & (s <= 2)).all()
    assert torch.equal(s[0, 1:][neg[:-1]], torch.fmod(sums[0, :-1][neg[:-1]], 3) + 3)


@pytest.mark.parametrize("kind,k,n", [("int8", 128, 128), ("int8", 96, 8), ("bf16", 96, 96)])
def test_kernel_operand_layout(kind, k, n):
    """B as the kernel reads it: plane p, column j, element e of step c is
    w[c, p * (16 / itemsize) + e, j]; f32 keeps w as it is."""
    _, w = P.probe_inputs(kind, k, n, grid=1, m=1, device="cpu")
    op = P.kernel_operand(w)
    per = 16 // w.element_size()
    assert op.is_contiguous() and op.dtype == w.dtype and op.numel() == w.numel()
    c, p, j, e = (torch.arange(x) for x in op.shape)
    kk = p[:, None, None] * per + e[None, None, :]
    want = w[c[:, None, None, None], kk[None], j[None, None, :, None]]
    assert torch.equal(op, want)
    wf = w.float()
    assert P.kernel_operand(wf) is wf


@pytest.mark.cuda
def test_cuda_kernels_match_plain():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    for _, kind, k, n in P.CASES:
        assert P.check_case(kind, k, n) == 0, (kind, k, n)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for kind, seed in (("int8", 0), ("bf16", 0), ("int8", P.NEGATIVE_SEED)):
        assert P.check_case(kind, 128, 128, grid=sms, seed=seed) == 0, (kind, seed)
    for kind in P.ISSUE_K:
        got = P.mma_issue(kind, 4, iters=64, device="cuda")
        assert torch.equal(got, P.mma_issue_reference(kind, 4, iters=64, device="cuda"))
