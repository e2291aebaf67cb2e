"""Sharded restoration: device meshes (mesh.py), halo-exchange spatial
sharding (spatial.py), frame sharding across processes (distributed.py)
and channel sharding (tensor.py). Counterpart of `qcnn_gpu_tpu/parallel/`."""

from qcnn_gpu_tpu_torch.parallel.mesh import Mesh, make_mesh, mesh_shape_for  # noqa: F401
from qcnn_gpu_tpu_torch.parallel.spatial import (  # noqa: F401
    halo_exchange_cols,
    halo_exchange_rows,
    make_sharded_forward,
    psnr_sharded,
)
