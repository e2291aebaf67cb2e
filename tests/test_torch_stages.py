"""Generation 3's diagnostic variants on the CPU (qcnn_gpu_tpu_torch/ops/
fused.py `stages`, `_debug`; tools/stage_marginals.py).

The plain version truncated after stage k (1..3) equals clamp(x + channel
0 of the oracle's `v1`, `conc1`, `conc2`, 0, 255) (models/oracle.py
`forward_blu(collect_intermediates=True)`); stages 4 equals `forward_blu`;
`zero_a1` equals the oracle's residual on a frame of 128s added to x.
Under frame bounds a truncated output equals the same stage on the
cropped frame. The numpy emulation of the kernel's layout
(tests/torch_split_emulation.py) reads each variant where `emit_stage`
does and equals the plain version. Tolerance: 0 everywhere (integer
arithmetic). On the card: tests/test_torch_stages_cuda.py."""

import ast
import glob
import os
import re

import numpy as np
import pytest
import torch

import torch_split_emulation as E
from qcnn_gpu_tpu.models import oracle as O
from qcnn_gpu_tpu.testing import synth_engine_params, synth_frames
from qcnn_gpu_tpu_torch.models.engine_params import EngineParams
from qcnn_gpu_tpu_torch.ops import fused as FU

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CASES = [(22, (3, 37, 53)), (27, (2, 13, 245)), (37, (1, 37, 53))]
INTERMEDIATE = {1: "v1", 2: "conc1", 3: "conc2"}


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fw(qp):
    return FU.FusedWeights.from_engine(EngineParams.from_arrays(synth_engine_params(qp)), "cpu")


def _plain(x, fw, *bounds, **kw):
    return FU.fused_forward_reference(torch.from_numpy(x), fw, *bounds, **kw).numpy()


@pytest.mark.parametrize("qp,shape", CASES, ids=lambda v: str(v))
@pytest.mark.parametrize("stages", [1, 2, 3])
def test_truncated_plain_equals_oracle_stage(stages, qp, shape):
    x = synth_frames(*shape, seed=sum(shape))
    _, inter = O.forward_blu(x, synth_engine_params(qp), collect_intermediates=True)
    a = inter[INTERMEDIATE[stages]][..., 0]
    assert a.any()  # the channel carries values, so the test can fail
    want = np.clip(x.astype(np.int64) + a, 0, 255)
    assert (_plain(x, _fw(qp), stages=stages) == want).all()


@pytest.mark.parametrize("qp,shape", CASES, ids=lambda v: str(v))
def test_stages_4_equals_forward_blu(qp, shape):
    x = synth_frames(*shape, seed=sum(shape))
    assert (_plain(x, _fw(qp), stages=4) == O.forward_blu(x, synth_engine_params(qp))).all()


@pytest.mark.parametrize("qp,shape", CASES, ids=lambda v: str(v))
def test_zero_a1_equals_oracle_residual_of_128s(qp, shape):
    x = synth_frames(*shape, seed=sum(shape))
    _, inter = O.forward_blu(np.full_like(x, 128), synth_engine_params(qp),
                             collect_intermediates=True)
    want = np.clip(x.astype(np.int64) + inter["res"][..., 0], 0, 255)
    assert (_plain(x, _fw(qp), _debug="zero_a1") == want).all()


@pytest.mark.parametrize("stages,debug", [(1, ""), (2, ""), (3, ""), (4, ""), (4, "zero_a1")])
def test_bounds_equal_the_cropped_frame(stages, debug):
    """Inside the bounds a variant equals itself on the cropped frame (the
    bounds are that frame's SAME padding, layer by layer); outside, a
    truncated build adds a masked 0, so x comes back."""
    fw = _fw(27)
    x = synth_frames(2, 21, 33, seed=6)
    r0, r1, c0, c1 = 4, 17, 1, 30
    got = _plain(x, fw, r0, r1, c0, c1, stages=stages, _debug=debug)
    crop = np.ascontiguousarray(x[:, r0:r1, c0:c1])
    assert (got[:, r0:r1, c0:c1] == _plain(crop, fw, stages=stages, _debug=debug)).all()
    if stages < 4:
        outside = np.ones(x.shape[1:], bool)
        outside[r0:r1, c0:c1] = False
        assert (got[:, outside] == x[:, outside]).all()


@pytest.mark.parametrize("tile", [(24, 40), (32, 32)], ids=lambda t: f"{t[0]}x{t[1]}")
@pytest.mark.parametrize("variant", FU.STAGE_VARIANTS, ids=lambda v: f"{v[0]}{v[1]}")
def test_emulated_variant_equals_plain(variant, tile):
    """The kernel's layout, emulated: each variant reads stage k's channel 0
    at the bytes `emit_stage` reads (the emulation raises on a byte the
    stage did not write that tile), under frame bounds, over several tiles
    per block."""
    stages, debug = variant
    fw = _fw(37)
    x = synth_frames(1, 30, 50, seed=2)
    bounds = (3, 27, 2, 44)
    got = E.emulate(x, fw, E.Design(*tile, 1, False), bounds=bounds, stages=stages,
                    zero_a1=bool(debug))
    assert (got == _plain(x, fw, *bounds, stages=stages, _debug=debug)).all()


@pytest.mark.parametrize("stages,debug,match", [
    (0, "", "1..4"), (5, "", "1..4"), (2.0, "", "1..4"), (True, "", "1..4"),
    (1, "zero_a1", "stages 4"), (4, "raw_out", "adds the residual inside its S4"),
    (4, "no_split", "only mode"), (4, "zero_a2", "unknown _debug"),
])
def test_a_bad_variant_raises(stages, debug, match):
    fw = _fw(37)
    x = torch.zeros((1, 8, 8), dtype=torch.uint8)
    for fn in (FU.fused_forward, FU.fused_forward_reference):
        with pytest.raises(ValueError, match=match):
            fn(x, fw, stages=stages, _debug=debug)


def test_cpu_variant_takes_the_plain_version():
    fw = _fw(37)
    x = torch.from_numpy(synth_frames(1, 19, 23, seed=3))
    before = dict(FU.fused_forward.stage_launches), FU.fused_forward.launches
    for stages, debug in FU.STAGE_VARIANTS:
        got = FU.fused_forward(x, fw, tile=(24, 32), stages=stages, _debug=debug)
        assert torch.equal(got, FU.fused_forward_reference(x, fw, stages=stages, _debug=debug))
    assert (dict(FU.fused_forward.stage_launches), FU.fused_forward.launches) == before


def test_stage_marginals_refuses_without_cuda():
    from qcnn_gpu_tpu_torch.tools import stage_marginals

    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="needs a CUDA GPU"):
        stage_marginals.main([])
    args = stage_marginals._parse([])
    assert (args.h, args.w, args.batch) == (1080, 1920, 8)  # scripts/stage_marginals.py's


def test_diagnostic_entry_mirrors_ops_fused():
    """csrc lists the variants once (QVRCNN_STAGE_VARIANTS), as
    ops/fused.STAGE_VARIANTS; the diagnostic tile must be one of
    QVRCNN_TILES (= ops/fused.TILES), named by the defines
    `stage_defines` passes; the main entry is compiled only without them."""
    csrc = os.path.join(REPO, "qcnn_gpu_tpu_torch", "csrc")
    with open(os.path.join(csrc, "qvrcnn_fused.cu")) as fp:
        src = fp.read()
    with open(os.path.join(csrc, "qvrcnn_split.cuh")) as fp:
        split = fp.read()
    line = re.search(r"#define QVRCNN_STAGE_VARIANTS\(X\) (.*)", src).group(1)
    got = [(int(s), z == "true") for s, z in re.findall(r"X\((\d), (true|false)\)", line)]
    assert got == [(s, bool(d)) for s, d in FU.STAGE_VARIANTS]
    assert re.search(r"static_assert\(false QVRCNN_TILES\(QVRCNN_IS_DIAG_TILE\)", src)
    for th, tw in FU.TILES:
        assert FU.stage_defines((th, tw)) == (f"QVRCNN_DIAG_TH={th}", f"QVRCNN_DIAG_TW={tw}")
    names = {d.split("=")[0] for d in FU.stage_defines(FU.TILES[0])}
    assert names == set(re.findall(r"Gen3<(QVRCNN_DIAG_TH), (QVRCNN_DIAG_TW), S, Z>", src)[0])
    main_entry = src.index("int qvrcnn_fused_forward(")
    diag_entry = src.index("int qvrcnn_fused_stages(")
    assert src.rindex("#ifndef QVRCNN_DIAG_TH", 0, main_entry) < main_entry
    assert src.rindex("#else", 0, diag_entry) > main_entry
    # emit_stage (the template's, which each variant instantiates): S1 and
    # S3 in buffer A, S2 in B, 4, 2, 1 positions in
    assert "OFF = K == 1 ? 4 : (K == 2 ? 2 : 1)" in split
    assert "K == 1 ? Geo::P1 : (K == 2 ? Geo::P2 : Geo::P3)" in split
    assert "(K == 2 ? Geo::OFF_B : Geo::OFF_A)" in split
    for k in (1, 2, 3):
        assert f"if constexpr (C::STAGES == {k})" in split
        assert f"emit_stage<C, {k}>" in split
    assert "!C::ZERO_A1 && i < Geo::RAW" in split
    lay = FU.layout(*FU.TILES[0])
    assert [(r - lay.th) // 2 for r in lay.rows[1:]] == [4, 2, 1]


def _keywords(path):
    with open(path) as fp:
        tree = ast.parse(fp.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            yield from (k.arg for k in node.keywords)


def test_nothing_else_passes_a_variant():
    """Only the tool (and fused_forward, forwarding to its plain version)
    passes `stages` or `_debug`: the main path never reaches the
    diagnostic library."""
    allowed = {os.path.join("ops", "fused.py"), os.path.join("tools", "stage_marginals.py")}
    pkg = os.path.join(REPO, "qcnn_gpu_tpu_torch")
    passing = {os.path.relpath(p, pkg)
               for p in glob.glob(os.path.join(pkg, "**", "*.py"), recursive=True)
               if {"stages", "_debug"} & set(_keywords(p))}
    assert passing <= allowed, passing - allowed
