"""Multi-device runs: device meshes, the sharded production engines
(``parallel.production``) and the whole-clip sidecar steps."""

from .mesh import make_mesh  # noqa: F401
from .pipeline import jit_stabilize_step, sharded_stabilize  # noqa: F401
