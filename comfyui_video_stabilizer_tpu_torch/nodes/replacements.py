"""Node-replacement migration: Inverse -> Motion Apply.

A copy of ``comfyui_video_stabilizer_tpu/nodes/replacements.py``:
declarative graph migration, as in the reference's
nodes/node_replacements.py — old
``video_stabilizer_inverse`` nodes load as Motion Apply with
``meta -> motion_meta``, forced crop_and_pad framing and bilinear
interpolation, identity output mapping.
"""

from __future__ import annotations

from .comfy_compat import HAVE_COMFY, io

REPLACEMENT_SPEC = dict(
    new_node_id="video_stabilizer_motion_apply",
    old_node_id="video_stabilizer_inverse",
    old_widget_ids=["padding_color"],
    input_mapping=[
        {"new_id": "frames", "old_id": "frames"},
        {"new_id": "motion_meta", "old_id": "meta"},
        {"new_id": "padding_color", "old_id": "padding_color"},
        {"new_id": "framing_mode", "set_value": "crop_and_pad"},
        {"new_id": "interpolation", "set_value": "bilinear"},
    ],
    output_mapping=[
        {"new_idx": 0, "old_idx": 0},
        {"new_idx": 1, "old_idx": 1},
        {"new_idx": 2, "old_idx": 2},
    ],
)


async def register_node_replacements() -> None:
    if not HAVE_COMFY:  # nothing to register standalone
        return
    from comfy_api.latest import ComfyAPI  # type: ignore

    api = ComfyAPI()
    await api.node_replacement.register(io.NodeReplace(**REPLACEMENT_SPEC))
