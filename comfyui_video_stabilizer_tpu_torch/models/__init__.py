"""Engines: the stabilization pipeline, the estimators, Motion Apply.

Exports the JAX package's ``models`` names: the ``geometry`` and
``shake`` submodules (numpy copies; no torch).
"""

from . import geometry, shake  # noqa: F401
