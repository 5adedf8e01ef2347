"""The port's package API: each public name of the JAX package's four
``__init__`` files (the top level, ``utils``, ``ops``, ``models``) and
the two stabilizer extension classes exist in the port's counterparts,
as the same kind of object.  The JAX names are read from the JAX
package's own modules, so a name added there is missed here until the
port has it.

Importing the port's top level loads neither torch nor an engine: a
subprocess checks ``sys.modules``.
"""

import ast
import asyncio
import inspect
import pathlib
import subprocess
import sys
import types

import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401

import comfyui_video_stabilizer_tpu as J  # noqa: E402
import comfyui_video_stabilizer_tpu.models as JModels  # noqa: E402
import comfyui_video_stabilizer_tpu.ops as JOps  # noqa: E402
import comfyui_video_stabilizer_tpu.utils as JUtils  # noqa: E402
from comfyui_video_stabilizer_tpu.nodes import stabilizer_nodes as JSN  # noqa: E402

import comfyui_video_stabilizer_tpu_torch as T  # noqa: E402
import comfyui_video_stabilizer_tpu_torch.models as TModels  # noqa: E402
import comfyui_video_stabilizer_tpu_torch.ops as TOps  # noqa: E402
import comfyui_video_stabilizer_tpu_torch.utils as TUtils  # noqa: E402
from comfyui_video_stabilizer_tpu_torch.nodes import stabilizer_nodes as TSN  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
PACKAGES = {"top": (J, T), "utils": (JUtils, TUtils), "ops": (JOps, TOps), "models": (JModels, TModels)}


def _public(module):
    """The public names the JAX ``__init__`` file itself binds (imports,
    assignments, definitions), read from its source: a submodule that
    another test happened to import is not one of them."""
    tree = ast.parse(pathlib.Path(module.__file__).read_text())
    names = set()
    for node in tree.body:
        if isinstance(node, ast.ImportFrom) and node.module != "__future__":
            names |= {a.asname or a.name for a in node.names}
        elif isinstance(node, ast.Assign):
            names |= {t.id for t in node.targets if isinstance(t, ast.Name)}
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            names.add(node.name)
    return {n for n in names if not n.startswith("_")}


def _kind(obj):
    if isinstance(obj, types.ModuleType):
        return "module"
    if inspect.isclass(obj):
        return "class"
    if callable(obj):
        return "async" if inspect.iscoroutinefunction(obj) else "function"
    return type(obj).__name__


@pytest.mark.parametrize("package", sorted(PACKAGES))
def test_init_exports_the_jax_names(package):
    jax_mod, port_mod = PACKAGES[package]
    names = _public(jax_mod)
    assert names, package
    for name in sorted(names):
        assert hasattr(port_mod, name), f"{port_mod.__name__} lacks {name}"
        assert _kind(getattr(port_mod, name)) == _kind(getattr(jax_mod, name)), name
    if package == "top":
        assert T.__version__ == J.__version__
    if package == "models":
        assert {TModels.geometry.__name__, TModels.shake.__name__} == {
            "comfyui_video_stabilizer_tpu_torch.models.geometry", "comfyui_video_stabilizer_tpu_torch.models.shake"}


def test_exports_are_the_port_modules_objects():
    from comfyui_video_stabilizer_tpu_torch.meta import motion_meta
    from comfyui_video_stabilizer_tpu_torch.ops import warp
    from comfyui_video_stabilizer_tpu_torch.utils import color, video_io

    assert T.MotionMeta is motion_meta.MotionMeta and T.resolve_motion_meta is motion_meta.resolve_motion_meta
    assert TUtils.normalize_video_input is video_io.normalize_video_input
    assert TUtils.parse_padding_color is color.parse_padding_color
    assert TOps.warp_clip_blur is warp.warp_clip_blur and TOps.coverage_mask is warp.coverage_mask
    with pytest.raises(AttributeError):
        TUtils.no_such_name
    with pytest.raises(AttributeError):
        TOps.no_such_name


@pytest.mark.parametrize("name", ["VideoStabilizerClassicExtension", "VideoStabilizerFlowExtension"])
def test_stabilizer_extension_classes(name):
    ref = asyncio.run(getattr(JSN, name)().get_node_list())
    ours = asyncio.run(getattr(TSN, name)().get_node_list())
    assert [c.__name__ for c in ours] == [c.__name__ for c in ref]
    assert all(c.__module__ == TSN.__name__ for c in ours)


def test_top_level_import_loads_no_torch_and_no_engine():
    code = ("import sys, comfyui_video_stabilizer_tpu_torch as T; T.MotionMeta; "
            "bad = [m for m in sys.modules if m.split('.')[0] in ('torch', 'jax', 'comfyui_video_stabilizer_tpu') "
            "or m.startswith('comfyui_video_stabilizer_tpu_torch.models')]; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=120)


@pytest.mark.parametrize("first", ["ops.warp", "utils.video_io", "utils.meshinfo", "ops", "utils", "ops.ransac"])
def test_no_import_cycle(first):
    """Whichever module is imported first, the package imports: the lazy
    exports break the ops/warp -> utils -> utils/video_io -> ops/warp loop."""
    code = (f"import comfyui_video_stabilizer_tpu_torch.{first}; "
            "import comfyui_video_stabilizer_tpu_torch.utils as U, comfyui_video_stabilizer_tpu_torch.ops as O; "
            "U.normalize_video_input, U.VideoContext, O.warp_clip")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=120)
