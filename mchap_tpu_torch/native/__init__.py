"""Native (C++) host-side components, loaded via ctypes.

``libbamreader``: BGZF + BAM decoder (bamreader.cpp) and CRAM 3.0
decoder (cramreader.cpp) sharing one columnar record layout
(records.h).  Built on demand with g++ (cached next to the source);
the pure-Python BAM reader remains the fallback when no toolchain is
available (CRAM has no Python fallback — it requires the native
library).
"""

import ctypes
import os
import subprocess

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRCS = [
    os.path.join(_DIR, "bamreader.cpp"),
    os.path.join(_DIR, "cramreader.cpp"),
]
_HDRS = [os.path.join(_DIR, "records.h")]
_LIB = os.path.join(_DIR, "libbamreader.so")

_lib = None
_tried = False


def _build():
    cmd = [
        "g++", "-O2", "-shared", "-fPIC", "-std=c++17",
        *_SRCS, "-o", _LIB, "-lz",
    ]
    subprocess.run(cmd, check=True, capture_output=True)


def load_library():
    """Return the ctypes library handle, building it if necessary.

    Returns None when the library cannot be built (no g++/zlib).
    """
    global _lib, _tried
    if _lib is not None:
        return _lib
    if _tried:
        return None
    _tried = True
    try:
        src_mtime = max(os.path.getmtime(s) for s in _SRCS + _HDRS)
        if (not os.path.exists(_LIB)) or (os.path.getmtime(_LIB) < src_mtime):
            _build()
        lib = ctypes.CDLL(_LIB)
    except Exception:
        return None
    c_char_p = ctypes.c_char_p
    c_void_p = ctypes.c_void_p
    lib.bam_load.restype = c_void_p
    lib.bam_load.argtypes = [c_char_p]
    lib.cram_load.restype = c_void_p
    lib.cram_load.argtypes = [c_char_p, c_char_p]
    lib.cram_load_region.restype = c_void_p
    lib.cram_load_region.argtypes = [
        c_char_p, c_char_p, c_char_p, ctypes.c_int64, ctypes.c_int64,
    ]
    lib.bam_error.restype = c_char_p
    lib.bam_free.argtypes = [c_void_p]
    lib.bam_n_records.restype = ctypes.c_int64
    lib.bam_n_records.argtypes = [c_void_p]
    lib.bam_n_refs.restype = ctypes.c_int64
    lib.bam_n_refs.argtypes = [c_void_p]
    for name in ("bam_header_text", "bam_ref_names", "bam_qname_blob",
                 "bam_seq_blob", "bam_qual_blob", "bam_aux_blob"):
        fn = getattr(lib, name)
        fn.restype = c_void_p  # raw pointer; wrapped with explicit sizes
        fn.argtypes = [c_void_p]
    for name in ("bam_ref_lengths", "bam_refid", "bam_pos", "bam_mapq",
                 "bam_flag", "bam_lseq", "bam_ncigar"):
        fn = getattr(lib, name)
        fn.restype = ctypes.POINTER(ctypes.c_int32)
        fn.argtypes = [c_void_p]
    for name in ("bam_qname_off", "bam_cigar_off", "bam_seq_off", "bam_aux_off"):
        fn = getattr(lib, name)
        fn.restype = ctypes.POINTER(ctypes.c_int64)
        fn.argtypes = [c_void_p]
    lib.bam_cigar_blob.restype = ctypes.POINTER(ctypes.c_uint32)
    lib.bam_cigar_blob.argtypes = [c_void_p]
    _lib = lib
    return _lib
