"""K8, the padding stats of a clip (``csrc/warp.cu::padding_stats_kernel``):
the float32 mask written once, 1 where the nearest source pixel of an
output pixel lies outside the frame, and its per-frame count.  The eight
coefficients a frame read and the counts written are a few bytes a frame,
left out.  Its operations, about 42 a pixel, take half the time its bytes
do at the float32 rate and about as long without fused multiply-adds
(the library is built without them), so the bytes are the bound read."""

from . import peaks


def bytes_moved(n: int, h: int, w: int) -> int:
    return 4 * n * h * w


def least_seconds(n: int, h: int, w: int) -> float:
    return peaks.least_seconds(bytes_moved(n, h, w))
