"""Engines: the stabilization pipeline and the Flow estimator."""
