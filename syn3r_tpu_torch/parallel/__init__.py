"""Placement of the port's work over several cards in one process (the
counterpart of ``syn3r_tpu/parallel``)."""

from .mesh import make_mesh, make_mesh_2d, replicated, sharded  # noqa: F401
from .pipeline_parallel import make_gpipe  # noqa: F401
from .sequence_parallel import make_sp_unet_forward  # noqa: F401
from .tensor_parallel import make_tp_unet_forward, unet_tp_shardings  # noqa: F401
