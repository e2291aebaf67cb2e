"""The H100 benchmark of the PyTorch and CUDA port (`qcnn_gpu_tpu_torch`): `run.py` runs one cell of `BENCHMARK.json`."""
