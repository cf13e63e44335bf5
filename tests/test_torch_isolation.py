"""The port, chip_smoke.py and the port's scripts import no JAX, flax, msgpack or building_gan_tpu.

The machine with the card has none of them, so one such import anywhere in
the port, even of a module that is itself numpy-only, fails there at import.
It has no tensorboardX either, so the port imports that only inside a
function (the trainer's writer factory), never when a module is imported.
The walk reads the sources with ``ast``; it imports nothing.  The port's
native host runtime (``building_gan_torch/native``) is its own copy of the C++
sources: no file there names the JAX package.
"""

import ast
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "msgpack", "optax", "building_gan_tpu")
LAZY_ONLY = ("tensorboardX", "matplotlib", "mpl_toolkits", "PIL")
TRAINER_SLICE = ("data/pipeline.py", "checkpoint/ckpt.py", "train/trainer.py", "train/writer.py",
                 "cli/main.py")
DP_SLICE = ("parallel/mesh.py", "parallel/dp.py")
SP_SLICE = ("parallel/sp.py",)
NATIVE_SLICE = ("native/parser.py", "serving/batcher.py", "data/preprocess.py")
SCRIPTS = ("scripts/torch_demo_train.py",)  # run on the card: the assay's entry point


def _sources():
    out = [os.path.join(ROOT, "chip_smoke.py")] + [os.path.join(ROOT, p) for p in SCRIPTS]
    for dirpath, _, files in os.walk(os.path.join(ROOT, "building_gan_torch")):
        out += [os.path.join(dirpath, f) for f in sorted(files) if f.endswith(".py")]
    return out


def _imports(path, tree=None):
    if tree is None:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module
        elif (
            isinstance(node, ast.Call)
            and getattr(node.func, "attr", getattr(node.func, "id", None)) in ("import_module", "__import__")
            and node.args
            and isinstance(node.args[0], ast.Constant)
        ):
            yield str(node.args[0].value)


def _import_time_nodes(tree):
    """The statements a module runs when it is imported: not function bodies."""
    todo = list(tree.body)
    while todo:
        node = todo.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            continue
        yield node
        todo.extend(ast.iter_child_nodes(node))


def test_walk_finds_the_port():
    paths = _sources()
    assert os.path.exists(paths[0]), "chip_smoke.py is missing"
    for module in ("ops/hourglass.py",) + TRAINER_SLICE + DP_SLICE + SP_SLICE + NATIVE_SLICE:
        assert any(p.endswith(os.path.join("building_gan_torch", *module.split("/"))) for p in paths)
    for script in SCRIPTS:
        assert os.path.join(ROOT, script) in paths and os.path.exists(os.path.join(ROOT, script))


def test_native_sources_are_the_ports_own():
    native = os.path.join(ROOT, "building_gan_torch", "native")
    names = sorted(os.listdir(native))
    assert {"batcher.cc", "buildingjson.cc", "parser.py"} <= set(names)
    for name in names:
        if os.path.isfile(os.path.join(native, name)):
            with open(os.path.join(native, name)) as f:
                assert "building_gan_tpu" not in f.read(), name


@pytest.mark.parametrize("path", _sources(), ids=lambda p: os.path.relpath(p, ROOT))
def test_tensorboardx_is_imported_only_lazily(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    at_import = ast.Module(body=[n for n in _import_time_nodes(tree)
                                 if isinstance(n, (ast.Import, ast.ImportFrom))], type_ignores=[])
    bad = [m for m in _imports(path, at_import) if m.split(".")[0] in LAZY_ONLY]
    assert not bad, f"{os.path.relpath(path, ROOT)} imports {bad} when it is imported"


@pytest.mark.parametrize("path", _sources(), ids=lambda p: os.path.relpath(p, ROOT))
def test_no_forbidden_imports(path):
    bad = [m for m in _imports(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{os.path.relpath(path, ROOT)} imports {bad}"
