from .motion_meta import (  # noqa: F401
    FrameTransform,
    MotionMeta,
    applied_motion_meta_from_stabilization_warp,
    build_motion_meta_v2,
    motion_meta_from_stabilization_warp,
    resolve_motion_meta,
    validate_motion_meta,
)
