"""`tools/compare_builds`: its reading of `ptxas -v` per tile instance
(`ops/build.ptxas_instances`), for generation 3's kernels as the split
template names them and as its own copy of the design named them before,
and its refusals without a GPU. Imports no JAX module."""

import pytest
import torch

from qcnn_gpu_tpu_torch.ops import build
from qcnn_gpu_tpu_torch.ops.fused import TILES
from qcnn_gpu_tpu_torch.tools import compare_builds

# ptxas -v lines as nvcc prints them, one entry per instance
_ENTRY = ("ptxas info    : Compiling entry function '{name}' for 'sm_90a'\n"
          "ptxas info    : Function properties for {name}\n"
          "    0 bytes stack frame, {spill} bytes spill stores, {spill} bytes spill loads\n"
          "ptxas info    : Used {regs} registers, used 1 barriers, 552 bytes cmem[0]\n")
TEMPLATE = "_ZN5split13qvrcnn_kernelINS_3CfgINS_8GeometryILi{th}ELi{tw}EEENS_6FoldedELb0ELi1ELb0ELi4ELb0EEEEEvPKhPvPKaPKiiiiNS_6BoundsEiii"
OWN = "_ZN12_GLOBAL__N_119qvrcnn_fused_kernelINS_4Geo3ILi{th}ELi{tw}EEELi4ELb0EEEvPKhPhPKaPKiiiiNS_6BoundsEiii"


@pytest.mark.parametrize("mangled", [TEMPLATE, OWN], ids=["template", "own"])
def test_instances_reads_each_tile(mangled):
    log = "".join(_ENTRY.format(name=mangled.format(th=th, tw=tw), spill=i, regs=100 + i)
                  for i, (th, tw) in enumerate(TILES))
    got = build.ptxas_instances("nvcc: warnings first\n" + log)
    assert got == {t: {"registers": 100 + i, "spill_stores": i, "spill_loads": i}
                   for i, t in enumerate(TILES)}


def test_refuses_without_cuda_or_arguments(monkeypatch):
    with pytest.raises(SystemExit, match="usage"):
        compare_builds.main([])
    # without a GPU it raises before it builds anything
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs a CUDA GPU"):
        compare_builds.main(["elsewhere/csrc"])
