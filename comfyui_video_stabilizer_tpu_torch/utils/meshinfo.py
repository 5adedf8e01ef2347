"""The active device mesh of a multi-device run.

Counterpart of ``comfyui_video_stabilizer_tpu/utils/meshinfo.py``.  The
engines run the same code with and without a mesh: under
:func:`set_mesh` each device stage (the gray and pool, estimation, the
padding stats and the warp) runs once for each shard of the clip, on the
shard's device, with the hand kernels (parallel/mesh.py).  The JAX
package swaps its estimation kernels for XLA mirrors under a mesh,
because a ``pallas_call`` does not partition; here every kernel runs on
each shard, so nothing is swapped.

The mesh is held in a ``contextvars.ContextVar``, so a mesh set in one
thread or task is not seen by another.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Iterator

_ACTIVE = contextvars.ContextVar("cvst_active_mesh", default=None)


@contextlib.contextmanager
def set_mesh(mesh) -> Iterator:
    """Make ``mesh`` (a parallel/mesh.py ``DeviceMesh``) the active mesh
    inside the ``with`` block."""
    token = _ACTIVE.set(mesh)
    try:
        yield mesh
    finally:
        _ACTIVE.reset(token)


def active_mesh():
    """The active mesh, else None."""
    return _ACTIVE.get()


def mesh_active() -> bool:
    return _ACTIVE.get() is not None


def data_shards(n: int):
    """Number of even frame-axis shards the active mesh gives an
    ``n``-frame clip, or None (no mesh, no ``data`` axis, one data shard
    or an uneven clip).

    Uneven clips take row bands or run whole on the lead device
    (parallel/production.py::input_partition_spec)."""
    mesh = _ACTIVE.get()
    if mesh is None or "data" not in mesh.axis_names:
        return None
    nd = int(mesh.shape["data"])
    if nd > 1 and n % nd == 0:
        return nd
    return None
