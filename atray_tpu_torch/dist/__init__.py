"""Distribution: ray sharding over the ranks of a ``torch.distributed``
process group (``mesh.py``, ``multihost.py``), the geometry-sharded treelet
render with its differentiable backends (``treelet.py``) and the trainer,
on one device or with its gradients summed over the ranks (``train.py``).

Exports what ``atray_tpu/dist/__init__.py`` does.
"""

from atray_tpu_torch.dist.mesh import make_device_mesh, render_sharded, trace_sharded
from atray_tpu_torch.dist.train import make_train_step
from atray_tpu_torch.dist.treelet import (
    build_treelet_accels,
    build_treelet_parts,
    build_treelets,
    render_treelet,
)

__all__ = ["build_treelet_accels", "build_treelet_parts", "build_treelets", "make_device_mesh",
           "make_train_step", "render_sharded", "render_treelet", "trace_sharded"]
