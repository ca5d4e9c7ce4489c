"""Build a CUDA source of the port for the host, with ``cuda_emu.h``.

``build(source, defines)`` rewrites what g++ cannot read (the CUDA
include, ``extern __shared__`` arrays, ``bar.sync`` and ``<<<...>>>``
launches) and compiles the source with g++ into a shared library under
``.build/emulated/`` that exports the same ``extern "C"`` functions as
the nvcc build, then loads it with ctypes.  Kernels then run on CPU
pointers, one block after another.  Returns None where g++ is missing.
"""

import ctypes
import hashlib
import os
import pathlib
import re
import shutil
import subprocess

HERE = pathlib.Path(__file__).resolve().parent
OUT = HERE.parent / ".build" / "emulated"


def _launch(m):
    name, cfg, args = m.group(1), m.group(2), m.group(3)
    parts = [x.strip() for x in cfg.split(",")] + ["0", "0"]
    return (f"emu_launch(dim3({parts[0]}), dim3({parts[1]}), (size_t)({parts[2]}),"
            f" [&]{{ {name}({args}); }});")


def host_source(src):
    src = src.replace("#include <cuda_runtime.h>", '#include "cuda_emu.h"')
    src = re.sub(r"extern __shared__ (?:__align__\(\d+\) )?(\w+(?: \w+)?) (\w+)\[\];",
                 r"\1* \2 = reinterpret_cast<\1*>(emu_dyn_smem());", src)
    src = re.sub(r'asm volatile\("bar\.sync %0, %1;" ::"r"\((.*?)\), "r"\((.*?)\) : "memory"\);',
                 r"emu_bar_sync((\1), (\2));", src)
    return re.sub(r"([\w:]+(?:<[^<>;]*>)?)<<<(.*?)>>>\((.*?)\);", _launch, src, flags=re.S)


def build(source, defines=()):
    gxx = shutil.which("g++")
    if gxx is None:
        return None
    src = host_source(pathlib.Path(source).read_text())
    header = (HERE / "cuda_emu.h").read_text()
    tag = hashlib.sha256((src + header + " ".join(defines)).encode()).hexdigest()[:12]
    so = OUT / f"lib{pathlib.Path(source).stem}_{tag}.so"
    if not so.exists():
        OUT.mkdir(parents=True, exist_ok=True)
        cpp = so.with_suffix(".cpp")
        cpp.write_text(src)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        cmd = [gxx, "-std=c++17", "-O2", "-fPIC", "-shared", "-ffp-contract=off", "-w",
               f"-I{HERE}", *(f"-D{d}" for d in defines), "-o", str(tmp), str(cpp)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode:
            raise RuntimeError(f"g++ failed on {source}:\n{proc.stderr[-4000:]}")
        tmp.replace(so)
    return ctypes.CDLL(str(so))
