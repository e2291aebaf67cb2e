"""The port's training path on the CPU — the patch dataset, the Adam
trainer, the shadow-weight fine-tune, checkpoints and the `train`,
`calibrate`, `finetune` and `eval-float` subcommands — against the JAX
package on the same seeded numpy inputs.

Tolerances:
  * batches, checkpoint arrays, tables and model files: 0 (elements, bytes);
  * Adam steps: losses within rtol 1e-4; params within 2*lr*steps
    (Adam moves a parameter by about lr a step whatever its gradient's
    size, so a gradient that is ~0 on one side and of the other sign on
    the other can part them by 2*lr a step) and their median within 1e-6;
  * the fine-tune: weights on the grid (round(w/s) within 1e-3 of an
    integer in the wbits range), grid integers equal to JAX's on at least
    99.9% of weights and one step apart at most elsewhere (a shadow weight
    within float32 rounding of a half step); the biases' moves as the
    Adam steps' above; the model files' int8 weights and int32 biases
    equal on at least 99.9% and one integer apart at most elsewhere;
  * eval-float: PSNR before equal, after within 1e-3 dB (predict_uint8's
    0.01% of pixels off by 1)."""

import contextlib
import io
import json
import os
import shutil

import numpy as np
import pytest
import torch

from qcnn_gpu_tpu import cli as jcli
from qcnn_gpu_tpu.data import datasets as JD
from qcnn_gpu_tpu.data import yuv
from qcnn_gpu_tpu.engine import calibrate as JC
from qcnn_gpu_tpu.models import float_model as JFM
from qcnn_gpu_tpu.parallel.mesh import make_mesh
from qcnn_gpu_tpu.quant.params import QuantTable as JQuantTable
from qcnn_gpu_tpu.train import checkpoint as JCK
from qcnn_gpu_tpu.train.finetune import quant_finetune as j_finetune
from qcnn_gpu_tpu.train.trainer import make_train_step
from qcnn_gpu_tpu_torch import cli
from qcnn_gpu_tpu_torch import testing as T
from qcnn_gpu_tpu_torch.data import datasets as D
from qcnn_gpu_tpu_torch.data import model_files as MF
from qcnn_gpu_tpu_torch.models import float_model as FM
from qcnn_gpu_tpu_torch.quant.params import QuantTable
from qcnn_gpu_tpu_torch.train import checkpoint as CK
from qcnn_gpu_tpu_torch.train.finetune import quant_finetune
from qcnn_gpu_tpu_torch.train.trainer import TrainConfig, Trainer

DEMO = T.asset("demo")
LR = 1e-3


def _pair(n, h, w, seed):
    clean = T.make_clean_frames(n, h, w, seed=seed)
    return clean, T.dct_compress(clean, q=28.0)


def _batches(steps, batch=4, patch=32, seed=0):
    ds = D.PatchDataset([_pair(2, 64, 96, seed)], patch=patch, seed=seed)
    return list(ds.batches(batch, steps))


def _jax(params):
    import jax.numpy as jnp

    return {k: jnp.asarray(v) for k, v in params.items()}


def _jax_adam(lr):
    import optax

    return optax.adam(lr)


def assert_trained_close(mine: FM.Params, theirs, steps, lr=LR):
    diffs = np.concatenate([np.abs(mine[k] - np.asarray(theirs[k])).ravel() for k in FM.PARAM_NAMES])
    assert diffs.max() <= 2 * lr * steps, diffs.max()
    assert np.median(diffs) <= 1e-6, np.median(diffs)


@pytest.mark.parametrize("patch,batch", [(64, 5), (32, 7)])
def test_patch_batches_equal_jax(patch, batch):
    """Every batch of two epochs and more (the reshuffles at each wrap,
    the extra one before the first batch included), from two sequences,
    and the prefetch loader's order."""
    pairs = [_pair(2, 96, 128, 1), _pair(1, 64, 96, 2)]
    mine = D.PatchDataset(pairs, patch=patch, seed=3)
    theirs = JD.PatchDataset(pairs, patch=patch, seed=3)
    assert mine.pieces == theirs.pieces
    steps = 2 * mine.pieces // batch + 3
    got = list(D.PrefetchLoader(mine.batches(batch, steps), depth=2))
    for (images, labels), (jimages, jlabels) in zip(got, theirs.batches(batch, steps), strict=True):
        assert images.dtype == np.float32 and images.shape == (batch, patch, patch, 1)
        assert (images == jimages).all() and (labels == jlabels).all()


def test_prefetch_loader_raises_the_producers_error():
    def gen():
        yield 1
        raise ValueError("bad batch")

    it = D.PrefetchLoader(gen())
    assert next(it) == 1
    with pytest.raises(ValueError, match="bad batch"):
        next(it)


@pytest.mark.parametrize("blu", [False, True], ids=["relu", "blu"])
def test_adam_steps_equal_jax(blu):
    """5 steps at batch 4 of 32x32 patches, lr 1e-3, from init_params(0)."""
    blu_ub = [0.3, 0.2, 0.2, 0.15, 0.15, 0.0] if blu else None
    batches = _batches(5)
    tr = Trainer(TrainConfig(lr=LR, log_every=0), device="cpu", blu_ub=blu_ub)
    losses = [tr.step_fn(tr.model, tr.opt, x, y).item() for x, y in batches]
    step, opt_init = make_train_step(make_mesh(1, 1), blu_ub, lr=LR)
    params = JFM.init_params(0)
    state = opt_init(params)
    jlosses = []
    for x, y in batches:
        params, state, loss = step(params, state, x, y)
        jlosses.append(float(loss))
    np.testing.assert_allclose(losses, jlosses, rtol=1e-4)
    assert_trained_close(tr.params, params, 5)


def test_fit_batches_logs_equal_jax(tmp_path, monkeypatch):
    """4 steps logged every 2: the metrics JSONL (loss within rtol 1e-4,
    batch PSNR within 1e-3 dB) and the image triplets (input and target
    equal, the output within 1 of JAX's, as predict_uint8); the triplet
    falls back to the same PGM bytes as the JAX package's without PIL."""
    import sys

    from qcnn_gpu_tpu.train.trainer import TrainConfig as JTrainConfig
    from qcnn_gpu_tpu.train.trainer import Trainer as JTrainer
    from qcnn_gpu_tpu.train.trainer import dump_image_triplet as j_dump
    from qcnn_gpu_tpu_torch.train.trainer import dump_image_triplet

    batches = _batches(4)
    logs = {}
    for side, tr in (("port", Trainer(TrainConfig(lr=LR, log_every=2), device="cpu")),
                     ("jax", JTrainer(JTrainConfig(lr=LR, log_every=2), mesh=make_mesh(1, 1)))):
        lines = []
        tr.fit_batches(batches, log_fn=lines.append, metrics_path=str(tmp_path / f"{side}.jsonl"),
                       image_dir=str(tmp_path / side))
        with open(tmp_path / f"{side}.jsonl") as fp:
            logs[side] = ([json.loads(r) for r in fp], lines)
    (mine, lines), (theirs, jlines) = logs["port"], logs["jax"]
    assert [r["step"] for r in mine] == [r["step"] for r in theirs] == [2, 4]
    assert [ln.split(":")[0] for ln in lines] == [ln.split(":")[0] for ln in jlines]
    np.testing.assert_allclose([r["loss"] for r in mine], [r["loss"] for r in theirs], rtol=1e-4)
    np.testing.assert_allclose([r["batch_psnr"] for r in mine], [r["batch_psnr"] for r in theirs],
                               atol=1e-3)
    from PIL import Image

    for step in (2, 4):
        name = f"triplet_{step:07d}.png"
        a = np.asarray(Image.open(tmp_path / "port" / name)).astype(int)
        b = np.asarray(Image.open(tmp_path / "jax" / name)).astype(int)
        w = (a.shape[1] - 8) // 3
        assert a.shape == b.shape and (a[:, :w] == b[:, :w]).all() and (a[:, -w:] == b[:, -w:]).all()
        assert np.abs(a - b).max() <= 1
    rng = np.random.default_rng(0)
    inp, out, target = (rng.integers(0, 256, (5, 7), dtype=np.uint8) for _ in range(3))
    with monkeypatch.context() as m:
        m.setitem(sys.modules, "PIL", None)  # `from PIL import Image` raises ImportError
        paths = [dump(str(tmp_path / d), 3, inp, out, target)
                 for dump, d in ((dump_image_triplet, "pgm-port"), (j_dump, "pgm-jax"))]
    assert all(p.endswith("triplet_0000003.pgm") for p in paths)
    assert open(paths[0], "rb").read() == open(paths[1], "rb").read()


def _continue_jax(params, opt_state, batches):
    step, _ = make_train_step(make_mesh(1, 1), lr=LR)
    losses = []
    for x, y in batches:
        params, opt_state, loss = step(params, opt_state, x, y)
        losses.append(float(loss))
    return params, losses


@pytest.mark.parametrize("origin", ["port", "jax", "ckpt-2000"])
def test_checkpoints_read_both_ways(origin, tmp_path):
    """A checkpoint written by one side (2 steps from init), or the
    committed ckpt-2000.npz, loads in both packages to the same arrays; 5
    more steps from it on either side give the same losses and params."""
    first, more = _batches(7)[:2], _batches(7)[2:]
    d = str(tmp_path / "ckpt")
    if origin == "port":
        tr = Trainer(TrainConfig(lr=LR, log_every=0), device="cpu")
        tr.fit_batches(first)
        tr.save_checkpoint(d)
    elif origin == "jax":
        step, opt_init = make_train_step(make_mesh(1, 1), lr=LR)
        params = JFM.init_params(0)
        state = opt_init(params)
        for x, y in first:
            params, state, _ = step(params, state, x, y)
        JCK.save_checkpoint(d, params, state, 2)
    else:
        os.makedirs(d)
        shutil.copy(os.path.join(DEMO, "ckpt", "ckpt-2000.npz"), d)
        with open(os.path.join(d, "latest"), "w") as fp:
            fp.write('{"file": "ckpt-2000.npz", "step": 2000}')
    template = JFM.init_params(0)
    jparams, jstate, jstep = JCK.load_checkpoint(d, template, _jax_adam(LR).init(template))
    params, adam, step0 = CK.load_checkpoint(d)
    assert step0 == jstep == (2000 if origin == "ckpt-2000" else 2)
    assert adam.count == int(jstate[0].count) == step0
    for k in FM.PARAM_NAMES:
        assert (params[k] == np.asarray(jparams[k])).all()
        assert (adam.mu[k] == np.asarray(jstate[0].mu[k])).all()
        assert (adam.nu[k] == np.asarray(jstate[0].nu[k])).all()
    tr = Trainer(TrainConfig(lr=LR, log_every=0), device="cpu")
    tr.load_checkpoint(d)
    assert tr.global_step == step0
    assert CK.adam_from_torch(tr.opt, tr.model).count == step0
    losses = [tr.step_fn(tr.model, tr.opt, x, y).item() for x, y in more]
    jparams, jlosses = _continue_jax(jparams, jstate, more)
    np.testing.assert_allclose(losses, jlosses, rtol=1e-4)
    assert_trained_close(tr.params, jparams, 5)
    # and the port's save of the continued state reads back unchanged
    tr.global_step += 5
    tr.save_checkpoint(d)
    p2, a2, s2 = CK.load_checkpoint(d)
    assert s2 == step0 + 5 and a2.count == step0 + 5
    for k in FM.PARAM_NAMES:
        assert (p2[k] == tr.params[k]).all()


def _grid_ints(params, stepw, wbits):
    lo, hi = -(1 << (wbits - 1)), (1 << (wbits - 1)) - 1
    out = []
    for i, w in enumerate(FM.params_to_lists(params)[0]):
        q = np.asarray(w) / np.asarray(stepw[i], np.float32)
        r = np.round(q)
        assert np.abs(q - r).max() < 1e-3 and r.min() >= lo and r.max() <= hi
        out.append(r.astype(np.int64).ravel())
    return np.concatenate(out)


def assert_grids_match(mine, theirs, stepw, wbits):
    a, b = _grid_ints(mine, stepw, wbits), _grid_ints(theirs, stepw, wbits)
    assert np.abs(a - b).max() <= 1 and (a == b).mean() >= 0.999, (a != b).sum()


@pytest.mark.parametrize("wbits", [8, 4])
def test_finetune_equal_jax(wbits):
    """5 fine-tune steps from ckpt-1500 on the demo table's grid (wbits 8),
    or on a 4-bit solve, with the table's clip bounds; biases train in
    float."""
    from qcnn_gpu_tpu_torch.engine.calibrate import solve_table

    params, _, _ = CK.load_checkpoint(os.path.join(DEMO, "ckpt"))
    if wbits == 8:
        table = QuantTable.load_pickle(os.path.join(DEMO, "quant_table.data"))
    else:
        table = solve_table(params, qp=37, wbits=4)
    batches = _batches(5, seed=4)
    before = {k: v.copy() for k, v in params.items()}
    mine = quant_finetune(params, table.stepw, batches, device="cpu", blu_ub=table.blu_adj,
                          lr=1e-4, log_every=0, wbits=wbits)
    theirs = j_finetune(_jax(params), table.stepw, make_mesh(1, 1), batches,
                        blu_ub=table.blu_adj, lr=1e-4, log_every=0, wbits=wbits)
    assert all((params[k] == before[k]).all() for k in FM.PARAM_NAMES)  # the input stays
    assert_grids_match(mine, theirs, table.stepw, wbits)
    # the biases' moves from the checkpoint: the same as JAX's, as
    # assert_trained_close holds params (max |diff| at most 2 * lr * steps,
    # the most two Adam runs can drift apart; median at most 1e-6), and
    # each side's median move at least a quarter of lr * steps, so frozen
    # or sign-flipped bias gradients fail
    bias = [k for k in FM.PARAM_NAMES if k.startswith("b_")]
    moved = np.concatenate([(mine[k] - params[k]).ravel() for k in bias])
    jmoved = np.concatenate([(np.asarray(theirs[k]) - params[k]).ravel() for k in bias])
    diffs = np.abs(moved - jmoved)
    assert diffs.max() <= 2 * 1e-4 * 5 and np.median(diffs) <= 1e-6, (diffs.max(), np.median(diffs))
    assert np.median(np.abs(jmoved)) >= 1e-4 * 5 / 4, np.median(np.abs(jmoved))


# ---- the CLI subcommands on small YUV files --------------------------------


@pytest.fixture(scope="module")
def seq(tmp_path_factory):
    """Two 64x96 frames: clean originals and their DCT anchors, YUV 4:2:0."""
    d = tmp_path_factory.mktemp("seq")
    clean, anchor = _pair(2, 64, 96, 9)
    paths = {"ori": str(d / "ori.yuv"), "anchor": str(d / "anchor.yuv")}
    yuv.write_y_as_420(paths["ori"], clean)
    yuv.write_y_as_420(paths["anchor"], anchor)
    return paths


def _run(main, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    return rc, out.getvalue(), err.getvalue()


def _geometry(seq):
    return ["--ori", seq["ori"], "--anchor", seq["anchor"], "--height", "64", "--width", "96",
            "--frames", "2"]


def test_cli_train_equal_jax(seq, tmp_path):
    """3 steps at batch 8 (the JAX CLI spreads a batch over the 8 CPU
    devices of the tests' mesh), lr 1e-3, seed 0; then 2 more resumed."""
    args = ["train", *_geometry(seq), "--steps", "3", "--batch-size", "8", "--lr", str(LR)]
    rc, out, _ = _run(cli.main, args + ["--ckpt", str(tmp_path / "port"), "--device", "cpu"])
    assert rc == 0 and out.startswith(f"trained 3 steps -> {tmp_path / 'port'}; last loss ")
    assert _run(jcli.main, args + ["--ckpt", str(tmp_path / "jax")])[0] == 0
    mine, adam, step = CK.load_checkpoint(str(tmp_path / "port"))
    theirs, jadam, jstep = CK.load_checkpoint(str(tmp_path / "jax"))
    assert step == jstep == 3 and adam.count == jadam.count == 3
    assert_trained_close(mine, theirs, 3)
    rc, out, _ = _run(cli.main, ["train", *_geometry(seq), "--steps", "2", "--batch-size", "8",
                                 "--ckpt", str(tmp_path / "port"), "--resume", "--device", "cpu"])
    assert rc == 0 and CK.load_checkpoint(str(tmp_path / "port"))[2] == 5


def test_cli_calibrate_equal_jax(seq, tmp_path):
    """From ckpt-1500: the presets' table and model (vect_c; 4-bit hwcn)
    byte-equal to the JAX CLI's; with --sample, the printed bounds within
    rtol 1e-5 of JAX's and the table JAX solves from them; --per-channel
    writes the pc model equal to JAX's, and raises where the JAX CLI
    would print success without the table asked for."""
    ckpt = os.path.join(DEMO, "ckpt")

    def both(extra, name):
        files = {}
        for side, main, dev in (("port", cli.main, ["--device", "cpu"]), ("jax", jcli.main, [])):
            outs = [] if "--per-channel" in extra else [
                "--table-out", str(tmp_path / f"{side}-{name}.table")]
            rc, out, err = _run(main, ["calibrate", "--ckpt", ckpt, *outs, "--model-out",
                                       str(tmp_path / f"{side}-{name}.model"), *extra, *dev])
            assert rc == 0, err
            files[side] = (out, [open(p, "rb").read() for p in sorted(tmp_path.glob(f"{side}-{name}.*"))])
        return files

    for name, extra in (("presets", ["--qp", "32"]),
                        ("int4", ["--wbits", "4", "--model-format", "hwcn"]),
                        ("pc", ["--per-channel", "--wbits", "4"])):
        files = both(extra, name)
        assert files["port"][1] == files["jax"][1] and len(files["port"][1]) == (1 if name == "pc" else 2)
    sample = ["--sample", seq["anchor"], "--height", "64", "--width", "96", "--frames", "2"]
    rc, out, err = _run(cli.main, ["calibrate", "--ckpt", ckpt, "--table-out", str(tmp_path / "s.table"),
                                   "--model-out", str(tmp_path / "s.model"), *sample, "--device", "cpu"])
    assert rc == 0, err
    bounds = [float(v) for v in out.splitlines()[0].removeprefix("blu bounds: ").split(", ")]
    params, _, _ = CK.load_checkpoint(ckpt)
    np.testing.assert_allclose(bounds, JC.calibrate_blu_bounds(_jax(params), yuv.read_y(seq["anchor"], 64, 96, 2)),
                               rtol=1e-5)
    jtable = JC.solve_table(_jax(params), blu_bounds=bounds)
    jtable.save_pickle(str(tmp_path / "j.table"))
    assert (tmp_path / "s.table").read_bytes() == (tmp_path / "j.table").read_bytes()
    for bad in (["--per-channel", "--table-out", str(tmp_path / "x")], ["--per-channel"],
                ["--model-format", "pc"]):
        rc, out, err = _run(cli.main, ["calibrate", "--ckpt", ckpt, *bad, "--device", "cpu"])
        assert rc == 1 and "lands in the pc model file" in err and not out
    assert not (tmp_path / "x").exists()


def test_cli_finetune_and_eval_float_equal_jax(seq, tmp_path):
    """finetune 3 steps at batch 8 from ckpt-1500 on the demo table: the
    _qfp checkpoints (step 1503, a fresh optimizer state: count 0, zero
    moments, as the JAX CLI saves it) and model files on the same grid;
    eval-float of each checkpoint: the same PSNR records."""
    table = os.path.join(DEMO, "quant_table.data")
    for side in ("port", "jax"):
        shutil.copytree(os.path.join(DEMO, "ckpt"), tmp_path / side)
        os.makedirs(tmp_path / f"eval-{side}")
    args = ["finetune", "--table", table, *_geometry(seq), "--steps", "3", "--batch-size", "8"]
    for side, main, dev in (("port", cli.main, ["--device", "cpu"]), ("jax", jcli.main, [])):
        rc, out, err = _run(main, args + ["--ckpt", str(tmp_path / side), "--model-out",
                                          str(tmp_path / f"{side}.model"), *dev])
        assert rc == 0, err
        assert out.strip() == f"finetuned 3 steps -> {tmp_path / side}_qfp, model -> {tmp_path / side}.model"
    mine, adam, step = CK.load_checkpoint(str(tmp_path / "port_qfp"))
    theirs, jadam, _ = CK.load_checkpoint(str(tmp_path / "jax_qfp"))
    assert step == 1503 and adam.count == jadam.count == 0
    assert all(not adam.mu[k].any() and not adam.nu[k].any() for k in FM.PARAM_NAMES)
    stepw = JQuantTable.load_pickle(table).stepw
    assert_grids_match(mine, theirs, stepw, 8)
    # the model files: int8 weights and int32 biases each within one
    # integer step of JAX's, and equal on at least 99.9%
    f_mine = MF.read_static_qfp_vect_c(str(tmp_path / "port.model"))
    f_theirs = MF.read_static_qfp_vect_c(str(tmp_path / "jax.model"))
    for field in ("weights", "biases"):
        a = np.concatenate([v.ravel() for v in getattr(f_mine, field)]).astype(np.int64)
        b = np.concatenate([v.ravel() for v in getattr(f_theirs, field)]).astype(np.int64)
        assert np.abs(a - b).max() <= 1 and (a == b).mean() >= 0.999, (field, (a != b).sum())
    records = {}
    for side, main, dev in (("port", cli.main, ["--device", "cpu"]), ("jax", jcli.main, [])):
        out_dir = str(tmp_path / f"eval-{side}")
        rc, out, err = _run(main, ["eval-float", "--ckpt", str(tmp_path / "port_qfp"),
                                   *_geometry(seq), "--out-dir", out_dir, *dev])
        assert rc == 0 and out.startswith("PSNR: before net "), err
        records[side] = [MF.read_psnr_goldens(os.path.join(out_dir, f)) for f in ("psnr_ori.data", "psnr.data")]
    assert (records["port"][0] == records["jax"][0]).all()
    np.testing.assert_allclose(records["port"][1], records["jax"][1], atol=1e-3)


def test_training_entry_points_need_a_device():
    """No CPU default: the trainer, the module and the fine-tune take a
    required device; a CUDA request without a card raises."""
    p = FM.init_params(0)
    for call in (lambda: Trainer(TrainConfig()), lambda: FM.FloatVRCNN(p),
                 lambda: quant_finetune(p, [1.0] * 6, [])):
        with pytest.raises(TypeError, match="device"):
            call()
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            Trainer(TrainConfig(), device="cuda")


def test_training_leaves_the_callers_arrays():
    """The module copies the params it is given and `params` hands back
    copies: steps on the module change neither (on the CPU a tensor made
    with as_tensor would share the arrays' memory)."""
    p = FM.init_params(0)
    given = {k: v.copy() for k, v in p.items()}
    tr = Trainer(TrainConfig(lr=LR, log_every=0), device="cpu", params=p)
    tr.fit_batches(_batches(1))
    snapshot = tr.params
    taken = {k: v.copy() for k, v in snapshot.items()}
    tr.fit_batches(_batches(1, seed=1))
    for k in FM.PARAM_NAMES:
        assert (p[k] == given[k]).all() and (snapshot[k] == taken[k]).all(), k
        assert not (tr.params[k] == taken[k]).all(), k  # the steps did move it
