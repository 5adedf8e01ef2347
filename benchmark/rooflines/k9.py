"""K9, the estimation gray and its integer pool (``csrc/gray.cu::
gray_pool_kernel``): each float32 source pixel read once and each float32
gray pixel written once.  About eight operations a source pixel take a
small share of the time its bytes do, so bytes bound it."""

from . import peaks


def bytes_moved(n: int, h: int, w: int, c: int, fy: int, fx: int) -> int:
    return 4 * n * (h * w * c + (h // fy) * (w // fx))


def least_seconds(n: int, h: int, w: int, c: int, fy: int, fx: int) -> float:
    return peaks.least_seconds(bytes_moved(n, h, w, c, fy, fx))
