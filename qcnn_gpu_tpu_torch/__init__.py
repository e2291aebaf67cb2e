"""qcnn_gpu_tpu_torch — the PyTorch/CUDA port of the QVRCNN INT8 engine.

A second package beside `qcnn_gpu_tpu` (the JAX/Pallas reference). It runs
the static INT8 restore path — model file -> Engine -> fused network ->
restored uint8 Y frames, PSNR and metric logs — on one NVIDIA Hopper GPU,
bit-exact to the integer contract of `qcnn_gpu_tpu.models.oracle`.

Layering (bottom -> top):
  ops/requant.py   exact integer requant epilogues on tensors
  models/qvrcnn.py parameter containers + the float64-exact reference net
  ops/fused.py     the fused-network kernel wrapper and its plain version
  csrc/            hand-written CUDA C++ kernels (sm_90a)
  ops/build.py     nvcc build of csrc/ into a ctypes-loaded library
  engine/          Engine (program cache, batched restore) + metrics log
  cli.py           `run` entry point

The port imports torch and never jax. Framework-neutral modules of the
JAX package (models.oracle, models.topology, data.*, quant, testing) are
used in place.
"""

__version__ = "0.1.0"
