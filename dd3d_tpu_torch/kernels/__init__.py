"""Build and load the port's hand-written CUDA kernels and its host C++ code.

Each source under dd3d_tpu_torch/csrc/ has a plain C interface. A `.cu`
source is compiled with nvcc for sm_90a, the host code (`imageio.cpp`, the
image reader; `kitti_eval.cpp`, the KITTI R40 engine) with g++ and OpenMP,
into a shared library under dd3d_tpu_torch/kernels/_build/ (listed in
.gitignore), named by a hash of the source, the csrc/ headers it includes
and the flags, on first use in a
process, and loaded with ctypes. Nothing is built when a module is imported,
and a failed build raises: no prebuilt library stands in.
"""
import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD_DIR = os.path.join(_PKG, "kernels", "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-fmad=false",
              "-shared", "-Xcompiler", "-fPIC")
# The host code with the JAX package's flags for its R40 engine
# (dd3d_tpu/evaluators/native/__init__.py:28).
GXX_FLAGS = ("-O3", "-fopenmp", "-shared", "-fPIC")

_LOADED = {}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels are built on first use")
    return found


def _compiler(source: str):
    """(compiler, flags) of a source: nvcc for `.cu`, g++ for `.cpp`."""
    if source.endswith(".cu"):
        return _nvcc(), NVCC_FLAGS
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError(f"g++ not found; the port's host code ({source}) is built on first use")
    return gxx, GXX_FLAGS


_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.M)


def _files(source: str):
    """`csrc/<source>` and every csrc/ header it includes with quotes,
    directly or through another header, in the order first met."""
    seen, todo = [], [source]
    while todo:
        name = todo.pop(0)
        if name in seen:
            continue
        seen.append(name)
        with open(os.path.join(_PKG, "csrc", name), "rb") as f:
            todo += [m.decode() for m in _INCLUDE.findall(f.read())]
    return seen


def _paths(source: str):
    """(source path, library path): the library is named by a hash of the
    source, the headers it includes and the flags, so that a changed header
    rebuilds every library that includes it."""
    src_path = os.path.join(_PKG, "csrc", source)
    flags = NVCC_FLAGS if source.endswith(".cu") else GXX_FLAGS
    h = hashlib.sha256(" ".join(flags).encode())
    for name in _files(source):
        with open(os.path.join(_PKG, "csrc", name), "rb") as f:
            h.update(b"\0" + name.encode() + b"\0" + f.read())
    digest = h.hexdigest()[:16]
    name = os.path.splitext(source)[0]
    return src_path, os.path.join(BUILD_DIR, f"lib{name}_{digest}.so")


def build_libraries(*sources: str) -> None:
    """Compile every source of `sources` that is not built yet, one compiler
    process each, all at once (cached by content hash)."""
    todo = [(source, *_paths(source)) for source in sources]
    todo = [t for t in todo if not os.path.exists(t[2])]
    if not todo:
        return
    os.makedirs(BUILD_DIR, exist_ok=True)
    jobs, tmps = [], []
    try:
        for source, src_path, lib_path in todo:
            compiler, flags = _compiler(source)
            # Build under a temporary name and rename: concurrent first uses
            # never load a half-written library.
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            tmps.append(tmp)
            proc = subprocess.Popen([compiler, *flags, "-o", tmp, src_path], stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE, text=True)
            jobs.append((src_path, lib_path, tmp, proc))
        failures = []
        for src_path, lib_path, tmp, proc in jobs:
            out, err = proc.communicate()
            if proc.returncode != 0:
                failures.append(f"{os.path.basename(proc.args[0])} failed on {src_path}:\n{out}\n{err}")
            else:
                os.replace(tmp, lib_path)
        if failures:
            raise RuntimeError("\n".join(failures))
    finally:
        for _, _, _, proc in jobs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for tmp in tmps:
            if os.path.exists(tmp):
                os.remove(tmp)


def load_library(source: str) -> ctypes.CDLL:
    """Compile `csrc/<source>` once (cached by content hash) and load it."""
    if source not in _LOADED:
        build_libraries(source)
        _LOADED[source] = ctypes.CDLL(_paths(source)[1])
    return _LOADED[source]
