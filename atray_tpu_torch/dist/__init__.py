"""Distribution: ray sharding over the ranks of a ``torch.distributed``
process group (``mesh.py``, ``multihost.py``), the geometry-sharded treelet
render (``treelet.py``) and the one-device trainer (``train.py``).

Exports what ``atray_tpu/dist/__init__.py`` does, less the training half
(``make_train_step``'s all-reduce and ``build_treelet_parts``:
``ROADMAP.md`` queue 1 item 3b).
"""

from atray_tpu_torch.dist.mesh import make_device_mesh, render_sharded, trace_sharded
from atray_tpu_torch.dist.treelet import build_treelet_accels, build_treelets, render_treelet

__all__ = ["build_treelet_accels", "build_treelets", "make_device_mesh", "render_sharded",
           "render_treelet", "trace_sharded"]
