"""qcnn_gpu_tpu_torch — the PyTorch/CUDA port of the QVRCNN INT8 engine.

A second package beside `qcnn_gpu_tpu` (the JAX/Pallas reference). It runs
the static INT8 restore path — model file -> Engine -> fused network ->
restored uint8 Y frames, PSNR and metric logs — on one NVIDIA Hopper GPU,
bit-exact to the integer contract of `qcnn_gpu_tpu.models.oracle`; and
the path that makes such a model: float training, calibration and the
quantization-aware fine-tune.

Layering (bottom -> top):
  models/topology.py, models/engine_params.py   the network and its integer parameters
  data/            static model files, YUV IO and PSNR, sequence manifests
  ops/requant.py   exact integer requant epilogues on tensors
  models/qvrcnn.py parameter containers + the float64-exact reference net
  ops/fused.py     generation 3 (folded epilogue) and the split design's layout
  ops/pair.py      generation 2: frame pairs, folded epilogue
  ops/literal.py   generation 1: literal BLU chain, int16 residual
  csrc/            hand-written CUDA C++ kernels (sm_90a): generations 3, 2
                   and 1 on one design (`wgmma`, hopper_wgmma.cuh)
  ops/build.py     nvcc build of csrc/ into ctypes-loaded libraries
  native/          the packed transports' host side in C++ (g++ at first use)
  engine/          Engine (program cache, transports, metrics log);
                   stream.py: pipelined restore on pinned rings and CUDA
                   streams; packed.py: the packed and duplex wire
                   transports
  parallel/        device meshes, halo-exchange sharding (generation 3 under
                   frame bounds) and DistributedRunner across processes
  config.py        the JSON Config (engine, training, data settings)
  quant/           the quant tables and their fixed-point solver
  models/float_model.py  the float VRCNN (training side, full float32)
  train/           float training, the shadow-weight fine-tune, checkpoints
  cli.py           `run` (`--mesh`, `--config`), `sweep`, `convert`,
                   `validate`, `calibrate-dynamic`, `train`, `calibrate`,
                   `finetune` and `eval-float`
  tools/           profile, bench_kernels, mma_probe (run on a CUDA GPU)

The port imports torch and nothing of jax or of the JAX package: what it
needs of the JAX package's framework-neutral modules it keeps as its own
copies (models/topology.py, models/engine_params.py, data/, quant/).
"""

__version__ = "0.1.0"
