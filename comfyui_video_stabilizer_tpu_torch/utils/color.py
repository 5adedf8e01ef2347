"""Padding-color parsing (never raises; falls back to neutral gray).

A copy of ``comfyui_video_stabilizer_tpu/utils/color.py`` (the same
code; tests/test_torch_host_copies.py holds the two equal).

Behavior parity with the reference's nodes/stabilizer_utils.py:
accepts ``#RGB`` / ``#RRGGBB`` hex strings, ``R,G,B`` / ``R/G/B`` lists
(single value broadcast to all channels), or an ``0xRRGGBB`` integer.
Any parse failure yields the default (127, 127, 127).
"""

from __future__ import annotations

from typing import Tuple

DEFAULT_PADDING_RGB: Tuple[int, int, int] = (127, 127, 127)


def _clamp8(value: int) -> int:
    return max(0, min(255, int(value)))


def parse_padding_color(value: str | int) -> Tuple[int, int, int]:
    if isinstance(value, str):
        stripped = value.strip()
        if "," in stripped or "/" in stripped:
            try:
                parts = stripped.replace("/", ",").replace(" ", ",").split(",")
                ints = [int(part) for part in parts if part != ""]
            except (TypeError, ValueError):
                return DEFAULT_PADDING_RGB
            if len(ints) == 1:
                ints = ints * 3
            if len(ints) != 3:
                return DEFAULT_PADDING_RGB
            return (_clamp8(ints[0]), _clamp8(ints[1]), _clamp8(ints[2]))
        hex_value = stripped.removeprefix("#")
        if len(hex_value) == 3:
            hex_value = "".join(ch * 2 for ch in hex_value)
        if len(hex_value) != 6:
            return DEFAULT_PADDING_RGB
        try:
            rgb_int = int(hex_value, 16)
        except (TypeError, ValueError):
            return DEFAULT_PADDING_RGB
    else:
        try:
            rgb_int = int(value)
        except (TypeError, ValueError):
            return DEFAULT_PADDING_RGB
    rgb_int = max(0, min(0xFFFFFF, rgb_int))
    return ((rgb_int >> 16) & 0xFF, (rgb_int >> 8) & 0xFF, rgb_int & 0xFF)
