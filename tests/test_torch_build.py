"""The ctypes binding of the port's CUDA kernels, checked on the CPU.

`lam_tpu_torch/ops/_build.py` loads the kernels' shared library with
ctypes and gives each C entry point the argument types in
`_build.SIGNATURES`. A wrong type is not caught anywhere: ctypes passes a
pointer given a 32-bit int slot as a cut-off int and the kernel faults or
reads the wrong memory, on the card only. These tests read every
`extern "C" int lam_*(...)` of `lam_tpu_torch/csrc/*.cu` and hold its
parameters against `SIGNATURES`: a pointer is `_P`, an `int` `_I`, a
`long long` `_L`, and no entry is left without a C function.
"""

import re

import pytest

from lam_tpu_torch.ops import _build

_ENTRY = re.compile(r'extern\s+"C"\s+int\s+(lam_\w+)\s*\(([^)]*)\)')


def _kind(param):
    """The ctypes type a C parameter declaration needs."""
    decl = " ".join(param.split())
    if "*" in decl:
        return _build._P
    if re.match(r"(const )?long long\b", decl):
        return _build._L
    if re.match(r"(const )?int\b", decl):
        return _build._I
    raise ValueError(f"no ctypes kind for the parameter {decl!r}")


def _c_entry_points():
    """{name: (source file name, [parameter declarations])} of every C
    entry point of the kernel sources."""
    out = {}
    for src in _build.sources():
        for name, params in _ENTRY.findall(src.read_text()):
            assert name not in out, f"{name} defined twice"
            params = [p for p in params.split(",") if p.strip()]
            out[name] = (src.name, params)
    return out


C_ENTRIES = _c_entry_points()


def test_the_sources_define_entry_points():
    assert len(C_ENTRIES) >= 30
    assert {"gemv_dense.cu", "gemv_symm.cu"} <= {f for f, _ in
                                                 C_ENTRIES.values()}


@pytest.mark.parametrize("name", sorted(C_ENTRIES))
def test_entry_point_argtypes_match_its_c_parameters(name):
    src, params = C_ENTRIES[name]
    assert name in _build.SIGNATURES, f"{name} ({src}) has no SIGNATURES entry"
    assert tuple(_build.SIGNATURES[name]) == tuple(map(_kind, params)), (
        f"{name} ({src}): SIGNATURES {_build.SIGNATURES[name]} against the C "
        f"parameters {params}")


@pytest.mark.parametrize("name", sorted(_build.SIGNATURES))
def test_signature_has_a_c_function(name):
    assert name in C_ENTRIES, f"SIGNATURES names {name}, which no csrc/*.cu "\
        "defines"


@pytest.mark.parametrize("param,kind", [
    ("const float* a", "_P"), ("void* stream", "_P"), ("double* part_d", "_P"),
    ("const short* q1", "_P"), ("long long* part", "_P"), ("int m", "_I"),
    ("long long nvec", "_L"), ("\n    int T", "_I")])
def test_parameter_kinds(param, kind):
    assert _kind(param) is getattr(_build, kind)


def test_unknown_parameter_kind_raises():
    with pytest.raises(ValueError, match="no ctypes kind"):
        _kind("float alpha")
