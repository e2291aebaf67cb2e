"""The matrix-rate probe (qcnn_gpu_tpu_torch/tools/mma_probe.py).

On the CPU: the chain's plain version `mma_probe_reference` equal to the
Pallas probe of `scripts/mfu_probe.py`, loaded by path and run in
interpret mode at M=64, GRID=2 (its module globals `M`, `GRID` and `pl`
replaced for the run; nothing in scripts/ changes), on the int8, bf16 and
f32 cases, against the last block's slot, which is the TPU's whole result;
the issue-rate kernel's plain version. On a GPU (skipped here): both
kernels equal to their plain versions. Tolerance: 0 (integer-valued
operands, every sum exact).

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
    assert P.kernel_operand(w).shape == (P.CHAIN, 8, 96)
    assert P.macs(a, w) == 32 * 96 * 8 * P.CHAIN


@pytest.mark.cuda
def test_cuda_kernels_match_plain():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    for _, kind, k, n in P.CASES:
        assert P.check_case(kind, k, n) == 0, (kind, k, n)
    for kind in P.ISSUE_K:
        got = P.mma_issue(kind, 4, iters=64, device="cuda")
        assert torch.equal(got, P.mma_issue_reference(kind, 4, iters=64, device="cuda"))
