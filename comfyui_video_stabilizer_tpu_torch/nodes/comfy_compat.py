"""ComfyUI V3 API compatibility layer (a copy of the JAX package's shim).

When ComfyUI is installed its real ``comfy_api.latest`` surface is
used verbatim; otherwise lightweight stubs with the same declarative
shape let the node classes import, declare schemas, and execute
standalone.  It is copied rather than imported because importing
``comfyui_video_stabilizer_tpu.nodes`` pulls in the JAX engines.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List

try:  # pragma: no cover - exercised only inside ComfyUI
    from comfy_api.latest import ComfyExtension, io  # type: ignore

    try:
        from comfy.utils import ProgressBar  # type: ignore
    except ImportError:
        ProgressBar = None
    try:
        import comfy.model_management as model_management  # type: ignore
    except ImportError:
        model_management = None
    HAVE_COMFY = True
except ImportError:
    HAVE_COMFY = False
    model_management = None

    class ProgressBar:  # type: ignore[no-redef]
        """No-op progress bar matching comfy.utils.ProgressBar."""

        def __init__(self, total: int):
            self.total = total
            self.current = 0

        def update_absolute(self, value: int, total: int | None = None) -> None:
            self.current = value
            if total is not None:
                self.total = total

    @dataclass
    class _SocketSpec:
        kind: str          # 'input' | 'output'
        io_type: str       # 'Image', 'Mask', 'Float', ... or custom
        id: str
        options: Dict[str, Any] = field(default_factory=dict)

    class _SocketFactory:
        def __init__(self, io_type: str):
            self.io_type = io_type

        def Input(self, id: str, **options: Any) -> _SocketSpec:
            return _SocketSpec("input", self.io_type, id, options)

        def Output(self, id: str, **options: Any) -> _SocketSpec:
            return _SocketSpec("output", self.io_type, id, options)

    class _NumberDisplay:
        number = "number"
        slider = "slider"

    class _ControlAfterGenerate:
        fixed = "fixed"
        increment = "increment"
        decrement = "decrement"
        randomize = "randomize"

    @dataclass
    class _Schema:
        node_id: str
        display_name: str = ""
        category: str = ""
        description: str = ""
        is_deprecated: bool = False
        inputs: List[_SocketSpec] = field(default_factory=list)
        outputs: List[_SocketSpec] = field(default_factory=list)

    class _NodeOutput:
        def __init__(self, *values: Any):
            self.values = values

        def __iter__(self):
            return iter(self.values)

        def __getitem__(self, idx):
            return self.values[idx]

        def __len__(self):
            return len(self.values)

    class _ComfyNode:
        @classmethod
        def define_schema(cls):  # pragma: no cover - overridden
            raise NotImplementedError

    @dataclass
    class _NodeReplace:
        new_node_id: str
        old_node_id: str
        old_widget_ids: List[str] = field(default_factory=list)
        input_mapping: List[Dict[str, Any]] = field(default_factory=list)
        output_mapping: List[Dict[str, Any]] = field(default_factory=list)

    class _IO:
        Schema = _Schema
        NodeOutput = _NodeOutput
        ComfyNode = _ComfyNode
        NodeReplace = _NodeReplace
        NumberDisplay = _NumberDisplay
        ControlAfterGenerate = _ControlAfterGenerate
        Image = _SocketFactory("Image")
        Mask = _SocketFactory("Mask")
        Float = _SocketFactory("Float")
        Int = _SocketFactory("Int")
        Boolean = _SocketFactory("Boolean")
        Combo = _SocketFactory("Combo")
        Color = _SocketFactory("Color")
        String = _SocketFactory("String")

        @staticmethod
        def Custom(type_name: str) -> "_SocketFactory":
            return _SocketFactory(type_name)

    io = _IO()  # type: ignore[assignment]

    class ComfyExtension:  # type: ignore[no-redef]
        async def get_node_list(self) -> list:
            return []

        async def on_load(self) -> None:
            return None


def check_interrupt() -> None:
    """Cooperative cancellation poll (no-op outside ComfyUI)."""
    if model_management is not None:
        model_management.throw_exception_if_processing_interrupted()
