"""Node cells: the 95th percentile of the traced window's calls, in ms; where the end-to-end tail spreads too widely."""

from benchmark.layers import call_ms_p95 as read  # noqa: F401
