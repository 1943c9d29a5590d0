"""Build and load the port's CUDA kernels (no JAX counterpart).

Every `csrc/*.cu` file is compiled by its own nvcc, all started at
once, for Hopper only, and the objects are linked into one shared
library with a plain C interface, which is loaded with ctypes:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
         -Xcompiler -fPIC -Xptxas -v -c -o <obj> csrc/<file>.cu   (each)
    nvcc -gencode arch=compute_90a,code=sm_90a -shared -o <lib> <objs>

No PyTorch header is compiled, so a build takes seconds, not minutes.
The library goes into `lam_tpu_torch/_build/` (listed in .gitignore) at
first use, under a name that carries a hash of the sources and flags, so
an edited source is rebuilt and an unchanged one is reused. nvcc's
output, including ptxas' register and spill report, is kept beside the
library as `<lib>.log`. A failed build raises with nvcc's output.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import time

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC.parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
# C entry points of csrc/gemv_symm.cu, csrc/gemv_dense.cu and
# csrc/stencil.cu: name -> argtypes (all return int)
SIGNATURES = {
    "lam_symm_tile": (),
    "lam_symm_strips": (),
    "lam_gemv_f32_symm": (_P, _P, _P, _P, _P, _I, _P),
    "lam_gemv_df64_symm": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _P),
    "lam_gemv_dfq_symm": (_P,) * 9 + (_I, _P),
    "lam_gemv_q16_symm": (_P, _P, _P, _P, _P, _P, _I, _P),
    "lam_gemv_fq_symm": (_P,) * 12 + (_I, _P),
    "lam_gemv_f32": (_P, _P, _P, _I, _I, _P),
    "lam_gemv_df64": (_P,) * 6 + (_I, _I, _P),
    "lam_gemv_f32_cols": (_P, _P, _P) + (_I,) * 4 + (_P,),
    "lam_gemv_df64_cols": (_P,) * 6 + (_I,) * 4 + (_P,),
    "lam_gemv_f32_symm_slab": (_P,) * 13 + (_I,) * 4 + (_P,),
    "lam_gemv_df64_symm_slab": (_P,) * 17 + (_I,) * 4 + (_P,),
    "lam_laplace5_blocks": (_I, _I),
    "lam_laplace5_f32_halo": (_P,) * 6 + (_I,) * 4 + (_P,),
}


def sources():
    return sorted(CSRC.glob("*.cu"))


def library_path(srcs=None):
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in srcs if srcs is not None else sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"liblam_kernels_{h.hexdigest()[:16]}.so"


def find_nvcc():
    nvcc = shutil.which("nvcc")
    if nvcc is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise RuntimeError("nvcc not found on PATH or in /usr/local/cuda/bin: "
                           "the CUDA kernels cannot be built")
    return nvcc


def build(nvcc=None):
    """Compile the sources unless the hashed library exists; returns
    (path, seconds spent compiling and linking, True if it built now)."""
    srcs = sources()
    out = library_path(srcs)
    if out.exists():
        return out, 0.0, False
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc or find_nvcc()
    tag = f"{out.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in srcs]
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    t0 = time.perf_counter()
    cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
            for src, obj in zip(srcs, objs)]
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]
    logs = [f"$ {' '.join(cmd)}\n{proc.communicate()[0]}"
            for cmd, proc in zip(cmds, procs)]
    failed = [proc.returncode for proc in procs if proc.returncode != 0]
    if not failed:
        cmd = [nvcc, *NVCC_FLAGS[:2], "-shared", "-o", str(tmp),
               *map(str, objs)]
        link = subprocess.run(cmd, capture_output=True, text=True)
        logs.append(f"$ {' '.join(cmd)}\n{link.stdout}{link.stderr}")
        if link.returncode != 0:
            failed.append(link.returncode)
    seconds = time.perf_counter() - t0
    log = "".join(logs)
    for obj in objs:
        obj.unlink(missing_ok=True)
    if failed:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed (exit {failed[0]}):\n{log}")
    pathlib.Path(f"{out}.log").write_text(log)
    os.replace(tmp, out)  # atomic: concurrent builds agree on the file
    return out, seconds, True


@functools.cache
def library():
    """The loaded kernel library, built at first use."""
    path, _, _ = build()
    lib = ctypes.CDLL(str(path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return lib
