"""Surface parity: every public name of the JAX package is in the port.

The guard walks every module of ``face_detection_tflite_tpu``
(``pkgutil.walk_packages``) except ``ops/nms_pallas.py``, whose function
K1 carries (``csrc/nms.cu`` behind ``ops/detections.py``).  For each
public name a module defines (functions, classes, constants, aliases) it
asserts that the port's module of the same path has it; for each public
function, and each public method, property, attribute and field of a
class, that the port's counterpart accepts every JAX parameter name (by
keyword, or through ``**kwargs``).

The port differs on purpose in the places :data:`DELIBERATE` lists, each
with its reason (ROADMAP §3 "Deliberate differences" holds the same
list).  One case a module holds it to its entries exactly, so an
undeclared gap fails there; one case an entry fails once the port closes
that gap (a stale entry).
"""

from __future__ import annotations

import ast
import dataclasses
import importlib
import inspect
import pkgutil

import pytest

import face_detection_tflite_tpu as jpkg

JAX_ROOT = "face_detection_tflite_tpu"
PORT_ROOT = "face_detection_tflite_torch"

#: JAX modules the guard does not walk, with the reason.
SKIPPED = {
    "ops.nms_pallas": "the Pallas NMS core: K1 carries its function "
                      "(csrc/nms.cu behind ops/detections.py)",
}

_BATCHED = ("batched: the port's function takes the whole batch "
            "([B, H, W, 3] frames, [B, F] ROI parameters) where the JAX "
            "one takes one image and is vmapped; its parameters are named "
            "for that")
_SHARDING = ("scale-out without jit: a mesh is a tuple of torch.device, "
             "the weights live in nn.Modules copied to each device, and "
             "data_parallel runs a program builder once a shard, so "
             "there is no mesh axis, params pytree or jitted program to "
             "pass")

#: ``"<module>:<name>"`` (a missing name) or ``"<module>:<qualname>(<param>)"``
#: (a missing parameter) -> why the port differs.
DELIBERATE = {
    "convert.executor:ConvertedModel.__init__(fn)":
        "a ConvertedModel is an nn.Module that runs its op list itself; "
        "there is no traced function to hand in "
        "(ConvertedModel.jax_params() gives the weights in the JAX keys)",
    "ops.letterbox:letterbox_image(img)": _BATCHED,
    "ops.warp:extract_rois(img)": _BATCHED,
    "ops.warp:extract_rois(cxs)": _BATCHED,
    "ops.warp:extract_rois(cys)": _BATCHED,
    "ops.warp:extract_rois(thetas)": _BATCHED,
    "models.embedding:embed_rois(model_fn)": _BATCHED,
    "models.embedding:embed_rois(params)": _BATCHED,
    "models.embedding:embed_rois(img)": _BATCHED,
    "models.embedding:embed_rois(cxs)": _BATCHED,
    "models.embedding:embed_rois(cys)": _BATCHED,
    "models.embedding:embed_rois(thetas)": _BATCHED,
    "parallel.sharding:make_mesh(axis_name)": _SHARDING,
    "parallel.sharding:shard_params(params)": _SHARDING,
    "parallel.sharding:shard_batch(axis_name)": _SHARDING,
    "parallel.sharding:data_parallel(program)": _SHARDING,
    "parallel.sharding:data_parallel(axis_name)": _SHARDING,
    "pipeline.detector:FaceDetector.__init__(use_pallas_nms)":
        "the Pallas NMS switch: K1 is the one postprocess on the card",
    "pipeline.programs:build_pipeline_program(use_pallas_nms)":
        "the Pallas NMS switch: K1 is the one postprocess on the card",
    "pipeline.programs:build_pipeline_program(batched)":
        "every port program is batched; there is no vmap to leave out",
    "pipeline.detector:default_compile_cache_dir":
        "programs are captured per key as CUDA graphs on the card, but a "
        "CUDA graph cannot be saved to disk; the kernels are built once "
        "into kernels/_build/",
    "pipeline.programs:PipelineModels.params":
        "the port's weights live in the networks' nn.Modules; "
        "ConvertedModel.jax_params() gives them in the JAX keys",
}


def _modules() -> list[str]:
    """The JAX package's module paths below its root, e.g.
    ``pipeline.timings``, minus :data:`SKIPPED`."""
    names = [m.name[len(JAX_ROOT) + 1:] for m in pkgutil.walk_packages(
        jpkg.__path__, JAX_ROOT + ".")]
    return sorted(n for n in names if n not in SKIPPED)


MODULES = _modules()


def _top_level_names(module) -> list[str]:
    """Public names that ``module``'s own source defines at top level:
    functions, classes and assignment targets (also inside a top-level
    ``if``, ``try`` or ``with``)."""
    with open(module.__file__, encoding="utf-8") as f:
        tree = ast.parse(f.read())
    names: list[str] = []

    def visit(body):
        for node in body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                names.append(node.name)
            elif isinstance(node, (ast.Assign, ast.AnnAssign)):
                targets = node.targets if isinstance(node, ast.Assign) \
                    else [node.target]
                names.extend(n.id for t in targets for n in ast.walk(t)
                             if isinstance(n, ast.Name))
            elif isinstance(node, (ast.If, ast.Try, ast.With)):
                visit(node.body)
                visit(getattr(node, "orelse", []))
                visit(getattr(node, "finalbody", []))
                for h in getattr(node, "handlers", []):
                    visit(h.body)
    visit(tree.body)
    return [n for n in dict.fromkeys(names) if not n.startswith("_")]


def _function(obj):
    """The plain function behind ``obj`` (a function, static or class
    method, or a property's getter), or None."""
    if isinstance(obj, (staticmethod, classmethod)):
        obj = obj.__func__
    if isinstance(obj, property):
        return None
    return obj if inspect.isfunction(obj) else None


def _missing_params(jax_fn, port_obj) -> list[str]:
    """The JAX function's parameter names that ``port_obj`` does not
    accept by keyword."""
    port_fn = _function(port_obj) or port_obj
    try:
        want = inspect.signature(jax_fn).parameters
        have = inspect.signature(port_fn).parameters
    except (TypeError, ValueError):
        return []
    if any(p.kind is p.VAR_KEYWORD for p in have.values()):
        return []
    named = {n for n, p in have.items() if p.kind not in (
        p.POSITIONAL_ONLY, p.VAR_POSITIONAL)}
    return [n for n, p in want.items()
            if p.kind not in (p.VAR_POSITIONAL, p.VAR_KEYWORD)
            and n not in named]


def _fields(cls) -> list[str]:
    """Dataclass and NamedTuple field names of ``cls``."""
    if dataclasses.is_dataclass(cls):
        return [f.name for f in dataclasses.fields(cls)]
    return list(getattr(cls, "_fields", ()))


def _class_gaps(prefix: str, jcls, pcls) -> list[str]:
    gaps = []
    for field in _fields(jcls):
        if not field.startswith("_") and field not in _fields(pcls) \
                and not hasattr(pcls, field):
            gaps.append(f"{prefix}.{field}")
    for attr, value in vars(jcls).items():
        if attr.startswith("_") and attr != "__init__":
            continue
        if not hasattr(pcls, attr):
            gaps.append(f"{prefix}.{attr}")
            continue
        fn = _function(value)
        if fn is not None:
            gaps += [f"{prefix}.{attr}({p})" for p in _missing_params(
                fn, inspect.getattr_static(pcls, attr))]
    return gaps


def _gaps(path: str) -> set[str]:
    """Every place where the port's ``path`` module lacks a public name or
    parameter of the JAX one, as :data:`DELIBERATE` keys."""
    jmod = importlib.import_module(f"{JAX_ROOT}.{path}")
    try:
        pmod = importlib.import_module(f"{PORT_ROOT}.{path}")
    except ModuleNotFoundError:
        return {f"{path}:<module>"}
    gaps = []
    for name in _top_level_names(jmod):
        if not hasattr(pmod, name):
            gaps.append(name)
            continue
        jobj, pobj = getattr(jmod, name), getattr(pmod, name)
        if inspect.isclass(jobj) and inspect.isclass(pobj):
            gaps += _class_gaps(name, jobj, pobj)
        elif inspect.isfunction(jobj):
            gaps += [f"{name}({p})" for p in _missing_params(jobj, pobj)]
    return {f"{path}:{g}" for g in gaps}


def test_the_walk_sees_the_package():
    """The walk reaches every layer, the modules this guard once caught
    gaps in among them, and every listed difference names a walked
    module."""
    for path in ("pipeline.timings", "utils.native", "models.embedding",
                 "pipeline.detector", "convert.executor", "cli"):
        assert path in MODULES
    assert {k.split(":")[0] for k in DELIBERATE} <= set(MODULES)
    assert all(reason.strip() for reason in DELIBERATE.values())


@pytest.mark.parametrize("path", MODULES)
def test_module_surface(path):
    """The port's module has every public name and parameter of the JAX
    one, except the deliberate differences listed for it."""
    listed = {k for k in DELIBERATE if k.split(":")[0] == path}
    undeclared = _gaps(path) - listed
    assert not undeclared, (
        f"the port lacks {sorted(undeclared)}: port them, or list each "
        f"in DELIBERATE (and ROADMAP §3) with its reason")


@pytest.mark.parametrize("entry", sorted(DELIBERATE))
def test_deliberate_entry_is_not_stale(entry):
    """Each listed difference is still one: an entry the port has closed
    must leave the list (and ROADMAP §3)."""
    assert entry in _gaps(entry.split(":")[0]), (
        f"{entry} is no longer a difference: remove it from DELIBERATE "
        f"and from ROADMAP §3")
