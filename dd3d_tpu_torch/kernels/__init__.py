"""Build and load the port's hand-written CUDA kernels.

Each source under dd3d_tpu_torch/csrc/ has a plain C interface. It is
compiled with nvcc for sm_90a into a shared library under
dd3d_tpu_torch/kernels/_build/ (listed in .gitignore), named by a hash of
the source and the flags, on first use in a process, and loaded with ctypes.
Nothing is built when a module is imported.
"""
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD_DIR = os.path.join(_PKG, "kernels", "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-fmad=false",
              "-shared", "-Xcompiler", "-fPIC")

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


def load_library(source: str) -> ctypes.CDLL:
    """Compile `csrc/<source>` once (cached by content hash) and load it."""
    if source in _LOADED:
        return _LOADED[source]
    src_path = os.path.join(_PKG, "csrc", source)
    with open(src_path, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    name = os.path.splitext(source)[0]
    lib_path = os.path.join(BUILD_DIR, f"lib{name}_{digest}.so")
    if not os.path.exists(lib_path):
        os.makedirs(BUILD_DIR, exist_ok=True)
        # Build under a temporary name and rename: concurrent first uses never
        # load a half-written library.
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, src_path], capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src_path}:\n{proc.stdout}\n{proc.stderr}")
            os.replace(tmp, lib_path)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
    lib = ctypes.CDLL(lib_path)
    _LOADED[source] = lib
    return lib
