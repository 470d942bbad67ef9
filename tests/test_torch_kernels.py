"""The host side of the port's CUDA kernels (`animals3d_tpu_torch.ops.kernels`)
on the CPU: where the library is imported from, and how it is built. A fake
compiler stands in for nvcc, so nothing here needs a card."""
import ast
import os
import sys
import threading
from concurrent.futures import ThreadPoolExecutor

import pytest
import torch

from animals3d_tpu_torch.ops import kernels

PKG = "animals3d_tpu_torch"
LIBRARY_MODULES = {f"{PKG}.ops.kernels", f"{PKG}.ops.rasterize_cuda"}

# writes its `-o` file in two chunks with a pause between them, as a
# compiler writes a library while another process may be building too
FAKE_NVCC = """import sys, time
out = sys.argv[sys.argv.index("-o") + 1]
with open(out, "wb") as f:
    f.write(b"A" * 4096)
    f.flush()
    time.sleep(0.5)
    f.write(b"B" * 4096)
print("ptxas info: fake")
sys.exit(int(sys.argv[1] == "fail"))
"""


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _modules():
    """(path, parsed tree) of every module of the package."""
    for dirpath, _dirs, files in os.walk(kernels._PKG_DIR):
        for fn in sorted(files):
            if fn.endswith(".py"):
                path = os.path.join(dirpath, fn)
                with open(path) as f:
                    yield path, ast.parse(f.read())


def _imported(node):
    """The modules an import statement names (for `from m import n`, both m
    and m.n; the package imports absolutely)."""
    if isinstance(node, ast.Import):
        return {a.name for a in node.names}
    return {node.module} | {f"{node.module}.{a.name}" for a in node.names}


def test_kernel_library_is_imported_at_module_top():
    """`ops.kernels` imports nothing of the port, and no function of the
    package imports the kernel library (`ops.kernels`, or
    `ops.rasterize_cuda` where it used to live): every kernel module
    imports it at its top, with no import cycle to work around."""
    inside, of_port = [], []
    for path, tree in _modules():
        imports = [n for n in ast.walk(tree)
                   if isinstance(n, (ast.Import, ast.ImportFrom))]
        if path == os.path.abspath(kernels.__file__):
            of_port = [n.lineno for n in imports
                       if any(m.split(".")[0] == PKG
                              for m in _imported(n))]
        for fn in ast.walk(tree):
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            for n in ast.walk(fn):
                if isinstance(n, (ast.Import, ast.ImportFrom)) \
                        and _imported(n) & LIBRARY_MODULES:
                    inside.append((path, n.lineno))
    assert of_port == []
    assert inside == []


def _fake_nvcc(tmp_path, monkeypatch, mode):
    """A fake nvcc (`FAKE_NVCC`, failing when mode is "fail") and an empty
    build directory in `tmp_path`, patched into `kernels`."""
    script = tmp_path / "fake_nvcc.py"
    script.write_text(FAKE_NVCC)
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(f'#!/bin/sh\nexec "{sys.executable}" "{script}" '
                    f'{mode} "$@"\n')
    nvcc.chmod(0o755)
    build_dir = tmp_path / "build"
    monkeypatch.setattr(kernels, "BUILD_DIR", str(build_dir))
    monkeypatch.setattr(kernels, "_nvcc", lambda: str(nvcc))
    return build_dir


def test_concurrent_builds_leave_one_whole_library(tmp_path, monkeypatch):
    """Two builds at once on a fresh build directory (the ranks of one job
    on a new checkout) both return, and leave the library whole under its
    hashed name and no temporary file; a later build finds it and does not
    compile."""
    build_dir = _fake_nvcc(tmp_path, monkeypatch, "ok")
    barrier = threading.Barrier(2)

    def build():
        barrier.wait(timeout=10)
        return kernels.build()
    with ThreadPoolExecutor(2) as pool:
        futures = [pool.submit(build) for _ in range(2)]
        outputs = [f.result(timeout=30) for f in futures]
    assert any("ptxas info" in out for out in outputs)
    out = kernels.library_path()
    with open(out, "rb") as f:
        assert f.read() == b"A" * 4096 + b"B" * 4096
    assert os.listdir(build_dir) == [os.path.basename(out)]
    assert kernels.build() == ""


def test_failed_build_leaves_no_temporary_file(tmp_path, monkeypatch):
    """A compiler that fails after writing part of its output raises, and
    leaves neither a library nor its temporary file behind."""
    build_dir = _fake_nvcc(tmp_path, monkeypatch, "fail")
    with pytest.raises(RuntimeError, match="nvcc failed"):
        kernels.build()
    assert os.listdir(build_dir) == []
