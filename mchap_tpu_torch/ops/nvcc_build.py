"""Build a kernel source of ``csrc/`` into a shared library, at first use.

``nvcc`` compiles ``csrc/<name>.cu`` for sm_90a into ``.build/kernels/``
with a plain C interface (loaded with ``ctypes``).  The file name
carries a hash of the source, so an edited source is rebuilt; ptxas's
resource report is kept in ``log_path(name)``.  Each kernel has its own
source and library, so editing one does not rebuild another.
"""

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / ".build" / "kernels"
MAX_SMEM = 227 * 1024  # bytes a block may use on Hopper (sm_90)


def log_path(name):
    return BUILD_DIR / f"{name}.log"


def build_library(name):
    """Compile ``csrc/<name>.cu`` (unless already built) and load it.

    Raises if the build fails, with the end of nvcc's error output.
    """
    source = CSRC / f"{name}.cu"
    digest = hashlib.sha256(source.read_bytes()).hexdigest()[:12]
    lib_path = BUILD_DIR / f"lib{name}_{digest}.so"
    if not lib_path.exists():
        nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [
            nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
            "-O3", "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
            "-Xptxas", "-v", "-o", str(tmp), str(source),
        ]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        log_path(name).write_text(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed on {source.name} ({proc.returncode}):\n"
                f"{proc.stderr[-4000:]}"
            )
        os.replace(tmp, lib_path)
    return ctypes.CDLL(str(lib_path))
