"""Build and load the port's CUDA kernels (no JAX counterpart).

Every `csrc/*.cu` file is compiled by its own nvcc, all started at
once, for Hopper only (the `csrc/*.cuh` headers they include are not
compiled alone), and the objects are linked into one shared library with
a plain C interface, which is loaded with ctypes:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
         -Xcompiler -fPIC -Xptxas -v -c -o <obj> csrc/<file>.cu   (each)
    nvcc -gencode arch=compute_90a,code=sm_90a -shared -o <lib> <objs>

No PyTorch header is compiled, so a build takes seconds, not minutes.
The library goes into `lam_tpu_torch/_build/` (listed in .gitignore) at
first use, under a name that carries a hash of the sources, headers and
flags, so an edited source is rebuilt and an unchanged one is reused. nvcc's
output, including ptxas' register and spill report, is kept beside the
library as `<lib>.log`. A failed build raises with nvcc's output.
`sass()` lists the machine code of each kernel in the library
(`cuobjdump -sass`).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import re
import shutil
import subprocess
import time

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC.parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
# C entry points of csrc/gemv_symm.cu, csrc/gemv_dense.cu, csrc/stencil.cu,
# csrc/probe.cu and csrc/q16_probe.cu: name -> argtypes (all return int)
SIGNATURES = {
    "lam_symm_tile": (),
    "lam_symm_strips": (),
    "lam_gemv_f32_symm": (_P, _P, _P, _P, _P, _I, _P),
    "lam_gemv_df64_symm": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _P),
    "lam_gemv_dfq_symm": (_P,) * 9 + (_I, _P),
    "lam_gemv_q16_symm": (_P, _P, _P, _P, _P, _P, _I, _P),
    "lam_gemv_fq_symm": (_P,) * 12 + (_I, _P),
    "lam_gemv_f32_symm_square": (_P, _P, _P, _P, _P, _I, _P),
    "lam_gemv_df64_symm_square": (_P,) * 8 + (_I, _P),
    "lam_gemv_df64_symm_bcast": (_P,) * 8 + (_I, _P),
    "lam_gemv_fq_symm_bcast": (_P,) * 12 + (_I, _I, _I, _P),
    "lam_gemv_fq_symm_zero": (_P,) * 8 + (_I, _P),
    "lam_gemv_f32": (_P, _P, _P, _I, _I, _P),
    "lam_gemv_df64": (_P,) * 6 + (_I, _I, _P),
    "lam_gemv_f32_cols": (_P, _P, _P) + (_I,) * 4 + (_P,),
    "lam_gemv_df64_cols": (_P,) * 6 + (_I,) * 4 + (_P,),
    "lam_gemv_df64_rows": (_P,) * 6 + (_I,) * 3 + (_P,),
    "lam_gemv_f32_symm_slab": (_P,) * 13 + (_I,) * 4 + (_P,),
    "lam_gemv_df64_symm_slab": (_P,) * 17 + (_I,) * 4 + (_P,),
    "lam_gemv_q16_symm_slab": (_P,) * 14 + (_I,) * 3 + (_P,),
    "lam_gemv_q16_symm_slab_twopass": (_P,) * 14 + (_I,) * 3 + (_P,),
    "lam_gemv_fq_symm_slab": (_P,) * 21 + (_I,) * 3 + (_P,),
    "lam_gemv_dfq_symm_slab": (_P,) * 18 + (_I,) * 3 + (_P,),
    "lam_gemv_df64_symm_slab_bcast": (_P,) * 17 + (_I,) * 3 + (_P,),
    "lam_gemv_df64_symm_slab_zero": (_P,) * 16 + (_I,) * 3 + (_P,),
    "lam_gemv_fq_symm_slab_bcast": (_P,) * 21 + (_I,) * 5 + (_P,),
    "lam_gemv_fq_symm_slab_zero": (_P,) * 17 + (_I,) * 3 + (_P,),
    "lam_gemv_f32_dual": (_P,) * 7 + (_I, _I, _P),
    "lam_gemv_df64_dual": (_P,) * 12 + (_I, _I, _P),
    "lam_gemv_dfq_dual": (_P,) * 13 + (_I, _I, _P),
    "lam_gemv_q16_dual": (_P,) * 8 + (_I, _I, _P),
    "lam_gemv_q16_dual_twopass": (_P,) * 8 + (_I, _I, _P),
    "lam_gemv_fq_dual": (_P,) * 16 + (_I, _I, _P),
    "lam_gemv_fq_dual_twopass": (_P,) * 16 + (_I, _I, _P),
    "lam_gemv_df64_dual_bcast": (_P,) * 12 + (_I, _I, _P),
    "lam_gemv_df64_dual_zero": (_P,) * 11 + (_I, _I, _P),
    "lam_gemv_fq_dual_bcast": (_P,) * 16 + (_I,) * 4 + (_P,),
    "lam_gemv_fq_dual_zero": (_P,) * 12 + (_I, _I, _P),
    "lam_gemv_q16_symm_bf16": (_P, _P, _P, _P, _P, _P, _I, _P),
    "lam_gemv_q16_symm_slab_bf16": (_P,) * 14 + (_I,) * 3 + (_P,),
    "lam_gemv_q16_dual_bf16": (_P,) * 8 + (_I, _I, _P),
    "lam_gemv_q16_dual_bf16_twopass": (_P,) * 8 + (_I, _I, _P),
    "lam_laplace5_blocks": (_I, _I),
    "lam_laplace5_f32_halo": (_P,) * 6 + (_I,) * 4 + (_P,),
    "lam_laplace5_f32_halo_twopass": (_P,) * 6 + (_I,) * 4 + (_P,),
    "lam_stream_i16": (_P, _L, _I, _P, _P, _P),
    "lam_convert_i16": (_P, _L, _I, _P, _P, _P),
    **{f"lam_gemv_q16_symm_{v}": (_P, _P, _P, _P, _P, _P, _I, _P)
       for v in ("magic", "tb1024", "sub8", "sub8_twopass", "split",
                 "split_twopass", "hi", "hi_twopass", "hybrid",
                 "hybrid_twopass")},
}


def sources():
    return sorted(CSRC.glob("*.cu"))


def library_path(srcs=None):
    """Where the library for the current sources, headers and flags
    lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    srcs = sources() if srcs is None else srcs
    for src in [*srcs, *sorted(CSRC.glob("*.cuh"))]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"liblam_kernels_{h.hexdigest()[:16]}.so"


def find_cuda_tool(tool="nvcc"):
    """The CUDA toolkit's `tool` (nvcc, cuobjdump) on PATH or in
    /usr/local/cuda/bin."""
    path = shutil.which(tool)
    if path is None and os.path.exists(f"/usr/local/cuda/bin/{tool}"):
        path = f"/usr/local/cuda/bin/{tool}"
    if path is None:
        raise RuntimeError(f"{tool} not found on PATH or in "
                           "/usr/local/cuda/bin: the CUDA kernels cannot be "
                           "built")
    return path


def build(nvcc=None):
    """Compile the sources unless the hashed library exists; returns
    (path, seconds spent compiling and linking, True if it built now)."""
    srcs = sources()
    out = library_path(srcs)
    if out.exists():
        return out, 0.0, False
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc or find_cuda_tool()
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


def sass(path=None):
    """{mangled kernel name: [its SASS instruction lines]} of the library
    (built at first use), from `cuobjdump -sass`."""
    path = path or build()[0]
    out = subprocess.run([find_cuda_tool("cuobjdump"), "-sass", str(path)],
                         capture_output=True, text=True, check=True).stdout
    kernels, name = {}, None
    for line in out.splitlines():
        head = re.match(r"\s*Function : (\S+)", line)
        if head:
            name = head.group(1)
            kernels[name] = []
        elif name is not None and re.match(r"\s*/\*[0-9a-f]{4,}\*/", line):
            kernels[name].append(line.strip())
    return kernels


def mma_engine(kernel):
    """The engine (csrc/symm_walk.cuh's MmaMode: 0 def, 1 split, 2 hi, 3
    hybrid) of a strip_mma_pass1 kernel, from the MODE near the end of its
    mangled StripCfg<..., bool BITS, bool EARLY, int MODE, int SUB>; None
    for any other kernel."""
    m = re.search(r"Lb[01]ELb[01]ELi(\d)ELi\d+EE", kernel)
    return int(m.group(1)) if m and "strip_mma_pass1" in kernel else None
