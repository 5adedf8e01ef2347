"""Binary mask morphology and the aspect-preserving rectangle search.

Counterpart of ``comfyui_video_stabilizer_tpu/ops/morphology.py``.
``dilate`` / ``erode`` are square max / min pools with stride 1 and an
implicit -inf / +inf border (``F.max_pool2d`` pads with -inf; erode is
the max pool of the negation), which is ``reduce_window`` "SAME" with
+-inf init there; on binary masks the two agree bitwise.
``content_bboxes`` runs on the masks' device and brings only the
per-frame boxes to the host.  ``integral_image`` and
``largest_aspect_ratio_rectangle`` are numpy copies (host code there
too).  ``largest_axis_aligned_rectangle`` runs the native histogram-stack
search (native/rectangle.cpp, built at first use; a failed build
raises, where the JAX package falls back quietly), and
``largest_axis_aligned_rectangle_plain`` is its numpy body, the plain
version the tests hold it to.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..native import rectangle as native_rectangle


def dilate(stack: torch.Tensor, radius: int = 1) -> torch.Tensor:
    """Square dilation of (N, H, W) masks (a (2r+1)^2 max, -inf border)."""
    k = 2 * radius + 1
    return F.max_pool2d(stack.to(torch.float32)[:, None], k, stride=1, padding=radius)[:, 0]


def erode(stack: torch.Tensor, radius: int = 1) -> torch.Tensor:
    """Square erosion of (N, H, W) masks (a (2r+1)^2 min, +inf border)."""
    return -dilate(-stack.to(torch.float32), radius)


def content_bboxes(stack: torch.Tensor):
    """Per-frame bounding boxes of mask > 0.5 as host int32 arrays
    (x_min, y_min, x_max, y_max); empty frames yield x_max = -1."""
    on = stack > 0.5
    rows_any = on.any(dim=2)  # (N, H)
    cols_any = on.any(dim=1)  # (N, W)
    big = np.iinfo(np.int32).max
    y_idx = torch.arange(stack.shape[1], device=stack.device)[None, :]
    x_idx = torch.arange(stack.shape[2], device=stack.device)[None, :]
    boxes = torch.stack([
        torch.where(cols_any, x_idx, big).amin(dim=1),
        torch.where(rows_any, y_idx, big).amin(dim=1),
        torch.where(cols_any, x_idx, -1).amax(dim=1),
        torch.where(rows_any, y_idx, -1).amax(dim=1),
    ]).to(torch.int32).cpu().numpy()
    return tuple(boxes)


def integral_image(mask: np.ndarray) -> np.ndarray:
    """(H+1, W+1) summed-area table (cv2.integral layout)."""
    h, w = mask.shape
    out = np.zeros((h + 1, w + 1), np.float64)
    np.cumsum(np.cumsum(mask.astype(np.float64), axis=0), axis=1, out=out[1:, 1:])
    return out


def largest_axis_aligned_rectangle(binary_mask: np.ndarray) -> Tuple[int, int, int, int]:
    """Largest all-ones axis-aligned rectangle, histogram-stack algorithm,
    natively.  Returns (x0, y0, w, h); (0, 0, W, H) for an all-zero mask."""
    return native_rectangle.largest_axis_aligned_rectangle(binary_mask)


def largest_axis_aligned_rectangle_plain(binary_mask: np.ndarray) -> Tuple[int, int, int, int]:
    """:func:`largest_axis_aligned_rectangle` in numpy: the same walk of the
    same histogram stack, so the same tuple."""
    height, width = binary_mask.shape
    heights = np.zeros(width + 1, dtype=np.int64)
    best_area = 0
    best_rect = (0, 0, width, height)
    row_pos = binary_mask > 0
    for y in range(height):
        heights[:width] = (heights[:width] + 1) * row_pos[y]
        stack: list[int] = []
        for x in range(width + 1):
            curr = heights[x]
            while stack and heights[stack[-1]] > curr:
                top = stack.pop()
                h = int(heights[top])
                left = stack[-1] + 1 if stack else 0
                area = h * (x - left)
                if area > best_area:
                    best_area = area
                    best_rect = (left, y - h + 1, x - left, h)
            stack.append(x)
    return best_rect


def largest_aspect_ratio_rectangle(
    binary_mask: np.ndarray,
    target_width: int,
    target_height: int,
) -> Tuple[float, float, float, float] | None:
    """Largest all-valid crop preserving the target aspect ratio.

    Integral image + binary search over the crop height; the centred
    placement is preferred.  Returns (x0, y0, width, height) or None.
    """
    if target_width <= 0 or target_height <= 0:
        return None
    height, width = binary_mask.shape
    aspect = float(target_width) / float(target_height)
    integral = integral_image(binary_mask > 0)

    def find_fit(crop_h: int):
        crop_w = int(np.ceil(aspect * crop_h))
        if crop_h <= 0 or crop_h > height or crop_w > width:
            return None
        sums = (
            integral[crop_h:, crop_w:]
            - integral[:-crop_h, crop_w:]
            - integral[crop_h:, :-crop_w]
            + integral[:-crop_h, :-crop_w]
        )
        matches = sums == crop_w * crop_h
        if not matches.any():
            return None
        y0 = int(np.clip(round((height - crop_h) * 0.5), 0, matches.shape[0] - 1))
        x0 = int(np.clip(round((width - crop_w) * 0.5), 0, matches.shape[1] - 1))
        if not matches[y0, x0]:
            y0, x0 = np.unravel_index(int(np.argmax(matches)), matches.shape)
        return int(x0), int(y0)

    low, high = 1, min(height, int(np.floor(width / aspect)))
    best = None
    while low <= high:
        crop_h = (low + high) // 2
        loc = find_fit(crop_h)
        if loc is None:
            high = crop_h - 1
        else:
            best = (loc[0], loc[1], crop_h)
            low = crop_h + 1
    if best is None:
        return None
    x0, y0, crop_h = best
    return float(x0), float(y0), aspect * crop_h, float(crop_h)
