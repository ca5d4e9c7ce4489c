"""Build a kernel source of ``csrc/`` into a shared library, at first use.

``nvcc`` compiles ``csrc/<name>.cu`` for sm_90a into ``.build/kernels/``
with a plain C interface (loaded with ``ctypes``).  The file name
carries a hash of the source, so an edited source is rebuilt; ptxas's
resource report is kept in ``log_path(name)``.  Each kernel has its own
source and library, so editing one does not rebuild another.  A source
may be built more than once with different ``-D`` macros into libraries
of their own, one ``nvcc`` each, so that its instances compile at once.
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


def build_library(name, source_name=None, defines=()):
    """Compile ``csrc/<source_name>.cu`` (default ``name``) with a ``-D``
    for each of ``defines`` into library ``name`` (unless already built)
    and load it.

    Raises if the build fails, with the end of nvcc's error output.
    """
    source = CSRC / f"{source_name or name}.cu"
    digest = hashlib.sha256(
        source.read_bytes() + "".join(f" -D{d}" for d in defines).encode()
    ).hexdigest()[:12]
    lib_path = BUILD_DIR / f"lib{name}_{digest}.so"
    if not lib_path.exists():
        nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [
            nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
            "-O3", "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
            "-Xptxas", "-v", *(f"-D{d}" for d in defines), "-o", str(tmp),
            str(source),
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
