"""Sharded restoration: device meshes, one process's or spanning processes
(mesh.py), halo-exchange spatial sharding (spatial.py), restoration over
every process's devices (distributed.py) and channel sharding
(tensor.py). Counterpart of `qcnn_gpu_tpu/parallel/`."""

from qcnn_gpu_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    make_global_mesh,
    make_mesh,
    mesh_shape_for,
)
from qcnn_gpu_tpu_torch.parallel.spatial import (  # noqa: F401
    halo_exchange_cols,
    halo_exchange_rows,
    make_sharded_forward,
    psnr_sharded,
)
