"""The import guard compares whole top-level names, and the reference
imports nothing of the program or of JAX."""
import ast
import os

from harness import guard, spec


def test_guard_names():
    assert guard.forbidden(["animals3d_tpu_torch",
                            "animals3d_tpu_torch.ops.fused_mlp",
                            "torch", "refmodel"]) == []
    assert guard.forbidden(["animals3d_tpu", "animals3d_tpu.ops"]) == \
        ["animals3d_tpu", "animals3d_tpu.ops"]
    assert guard.forbidden(["jax", "jax.numpy", "jaxlib", "flax.linen",
                            "jaxtyping"]) == ["flax.linen", "jax",
                                              "jax.numpy", "jaxlib"]


def _imports(root):
    for dirpath, _dirs, files in os.walk(root):
        for fn in files:
            if not fn.endswith(".py"):
                continue
            tree = ast.parse(open(os.path.join(dirpath, fn)).read())
            for node in ast.walk(tree):
                if isinstance(node, ast.Import):
                    for a in node.names:
                        yield fn, a.name
                elif isinstance(node, ast.ImportFrom) and node.module:
                    yield fn, node.module


def test_reference_imports_nothing_of_the_program():
    ref = os.path.join(spec.HERE, "refmodel")
    bad = [(f, m) for f, m in _imports(ref)
           if m.split(".")[0] in ("animals3d_tpu_torch", "animals3d_tpu",
                                  "jax", "jaxlib", "flax", "harness")]
    assert bad == []


def test_harness_imports_no_jax():
    bad = [(f, m) for f, m in _imports(spec.HERE)
           if m.split(".")[0] in guard.FORBIDDEN]
    assert bad == []
