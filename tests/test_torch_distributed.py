"""The port's DistributedRunner (qcnn_gpu_tpu_torch.parallel.distributed):
two processes on gloo over virtual CPU meshes, each returning the global
batch, and the one-process streams over the raw and duplex transports on
a 2x2 virtual CPU mesh. Held against the port's unsharded restore and the
JAX package's DistributedRunner (on its 8-device virtual CPU mesh);
tolerance 0, PSNR equal to the last bit."""

import json
import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from qcnn_gpu_tpu.parallel import make_mesh as jax_make_mesh
from qcnn_gpu_tpu.parallel.distributed import DistributedRunner as JaxRunner
from qcnn_gpu_tpu.testing import synth_engine_params as jax_synth_params
from qcnn_gpu_tpu_torch.data import yuv
from qcnn_gpu_tpu_torch.engine import packed as P
from qcnn_gpu_tpu_torch.models.qvrcnn import make_forward
from qcnn_gpu_tpu_torch.parallel import distributed as D
from qcnn_gpu_tpu_torch.parallel.mesh import make_mesh
from qcnn_gpu_tpu_torch.testing import synth_engine_params, synth_frames

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU4 = [torch.device("cpu")] * 4

WORKER = textwrap.dedent(
    """
    import json, sys
    sys.path.insert(0, {repo!r})
    import numpy as np
    import torch
    from qcnn_gpu_tpu_torch.parallel.distributed import DistributedRunner, initialize
    from qcnn_gpu_tpu_torch.parallel.mesh import make_mesh
    from qcnn_gpu_tpu_torch.testing import synth_engine_params, synth_frames

    rank, world, port, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
    total = int(sys.argv[5])
    torch.set_num_threads(2)
    initialize(f"tcp://127.0.0.1:{{port}}", world, rank)
    runner = DistributedRunner(synth_engine_params(37),
                               make_mesh(2, 1, devices=[torch.device("cpu")] * 2), impl="auto")
    frames = synth_frames(total, 32, 48, seed=5)
    ori = synth_frames(total, 32, 48, seed=6)
    local = np.array_split(frames, world)[rank]
    try:
        got = runner.restore(local)
    except ValueError as e:
        json.dump({{"error": str(e)}}, open(out + ".json", "w"))
        torch.distributed.destroy_process_group()
        sys.exit(0)
    np.save(out + ".npy", got)
    psnr = runner.psnr(np.array_split(got, world)[rank], np.array_split(ori, world)[rank])
    try:
        runner.restore_stream(local)
        refused = False
    except NotImplementedError:
        refused = True
    json.dump({{"psnr": psnr.hex(), "impl": runner.run.impl, "refused": refused}},
              open(out + ".json", "w"))
    torch.distributed.destroy_process_group()
    """
)


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _two_ranks(tmp_path, total):
    """Run WORKER as ranks 0 and 1 of a gloo group on `total` frames split
    by np.array_split; -> each rank's output path stem."""
    script = tmp_path / "worker.py"
    script.write_text(WORKER.format(repo=REPO))
    port = str(_free_port())
    outs = [str(tmp_path / f"rank{r}") for r in range(2)]
    procs = [subprocess.Popen([sys.executable, str(script), str(r), "2", port, outs[r],
                               str(total)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    logs = []
    try:
        for pr in procs:
            logs.append(pr.communicate(timeout=120)[0])
    finally:
        for pr in procs:
            pr.kill()
    assert [pr.returncode for pr in procs] == [0, 0], logs
    return outs


def test_two_process_restore_returns_the_global_batch(tmp_path):
    """Two processes, 4 frames each on a 2x1 virtual CPU mesh, gloo: both
    return the 8-frame global batch, equal to the unsharded restore and to
    the JAX DistributedRunner's; psnr (an all-reduce of per-block SSE)
    equals the host PSNR of the global batch; restore_stream refuses."""
    outs = _two_ranks(tmp_path, 8)
    p = synth_engine_params(37)
    frames, ori = synth_frames(8, 32, 48, seed=5), synth_frames(8, 32, 48, seed=6)
    whole = make_forward(p, device="cpu")(torch.from_numpy(frames)).numpy()
    jax_out = JaxRunner(jax_synth_params(37), mesh=jax_make_mesh(2, 2), impl="int").restore(frames)
    assert (jax_out == whole).all()
    for out in outs:
        got = np.load(out + ".npy")
        rec = json.load(open(out + ".json"))
        assert got.shape == frames.shape and (got == whole).all()
        assert rec["impl"] == "kernel3" and rec["refused"]
        assert float.fromhex(rec["psnr"]) == yuv.psnr(whole, ori)


def test_two_process_restore_refuses_unequal_frame_counts(tmp_path):
    """7 frames over 2 processes (4 and 3): both ranks raise ValueError
    naming the counts, ahead of the gather (which would otherwise fail or
    block)."""
    for out in _two_ranks(tmp_path, 7):
        rec = json.load(open(out + ".json"))
        assert "[4, 3] frames" in rec["error"]


@pytest.mark.parametrize("transport", ["raw", "duplex"])
def test_restore_stream_on_a_2x2_mesh_with_a_ragged_tail(transport):
    """7 frames at batch 4 on a 2x2 virtual CPU mesh: a full batch through
    the pipeline, then the tail of 3 edge-replicated to 4 and cropped;
    equal to the unsharded restore, twice over (the duplex continues its
    stream)."""
    p = synth_engine_params(37)
    frames = synth_frames(7, 32, 48, seed=2)
    frames[1:] = frames[:1]  # a static camera: the duplex packs steps
    frames[3:, 4:12, 8:24] = synth_frames(1, 8, 16, seed=3)[0]
    whole = make_forward(p, device="cpu")(torch.from_numpy(frames)).numpy()
    runner = D.DistributedRunner(p, make_mesh(2, 2, devices=CPU4))
    for _ in range(2):
        got = runner.restore_stream(frames, depth=2, transport=transport, batch_frames=4)
        assert (got == whole).all()
    stream = runner.engines[4].last_stream
    assert stream["served"] == transport and runner.engines[4].mesh is runner.mesh
    if transport == "duplex":  # the second stream's batch went packed
        assert stream["packed_steps"] >= 1 and stream["raw_tail_frames"] == 3


def test_restore_stream_checks_its_batch():
    runner = D.DistributedRunner(synth_engine_params(37), make_mesh(2, 2, devices=CPU4))
    frames = synth_frames(4, 32, 48, seed=2)
    with pytest.raises(ValueError, match="no multiple of the mesh's dp 2"):
        runner.restore_stream(frames, batch_frames=3)
    with pytest.raises(ValueError, match="transport"):
        runner.restore_stream(frames, transport="auto")
    assert (runner.restore_stream(frames) == runner.restore(frames)).all()  # batch = dp


def test_duplex_failure_raises_and_evicts_the_transport(monkeypatch):
    """No fallback to raw: the failure raises, the transport (whose carries
    may be out of step) is dropped, and the next stream starts afresh."""
    p = synth_engine_params(37)
    frames = synth_frames(8, 32, 48, seed=2)
    runner = D.DistributedRunner(p, make_mesh(2, 2, devices=CPU4))
    orig = P.DuplexTransport.receive
    calls = [0]

    def flaky(self, x, item, sink=None):
        calls[0] += 1
        if calls[0] == 2:
            raise RuntimeError("device lost")
        return orig(self, x, item, sink)

    monkeypatch.setattr(P.DuplexTransport, "receive", flaky)
    with pytest.raises(RuntimeError, match="device lost"):
        runner.restore_stream(frames, transport="duplex", batch_frames=4)
    assert runner.engines[4]._duplex == {}
    monkeypatch.setattr(P.DuplexTransport, "receive", orig)
    got = runner.restore_stream(frames, transport="duplex", batch_frames=4)
    assert (got == make_forward(p, device="cpu")(torch.from_numpy(frames)).numpy()).all()


def test_global_mesh_refuses_an_sp_axis_across_processes(monkeypatch):
    """Two processes of one device each, one frame: mesh_shape_for gives
    1x2, whose sp axis would span the processes."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(D, "world_size", lambda: 2)
    with pytest.raises(NotImplementedError, match="sp axis would span processes"):
        D.global_mesh(frames_hint=1)


def test_global_mesh_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(ValueError, match="no CUDA device"):
        D.global_mesh()


def test_initialize_is_a_no_op_for_one_process():
    D.initialize("tcp://127.0.0.1:1", world_size=1, rank=0)
    assert not torch.distributed.is_initialized() and D.world_size() == 1
