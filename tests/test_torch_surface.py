"""lam_tpu's import paths in the port: every name that a module of
lam_tpu exports (`__all__`) or defines publicly (a function or class
defined there, or an upper-case constant) resolves on the port's module of
the same path, but for the names that mean something only under JAX,
which are listed here, each with its reason. The list is exact: a later
port of such a name takes it off the list."""

import importlib
import inspect
import os
import pkgutil
import subprocess
import sys

import pytest

import lam_tpu

# (module, name): why the port has no such name
UNPORTED = {
    ("lam_tpu", "force_platform"):
        "selects JAX's platform; the port takes device= / --device",
    ("lam_tpu.solver.operators", "df64_plane_provider"):
        "a jax.make_array_from_callback helper for sharded df64 planes",
    ("lam_tpu.solver.operators", "MATVEC"):
        "jit-static table of matvec functions, keyed for tracing",
    ("lam_tpu.solver.operators", "MATVEC_COLS"):
        "jit-static table of column-block matvecs, keyed for tracing",
    ("lam_tpu.parallel.pcg", "MATVEC_COLS"):
        "jit-static table of the ring's column-block matvecs",
    ("lam_tpu.parallel.pcg2d", "AXES"): "the JAX mesh's axis names",
    ("lam_tpu.parallel.pcg2d", "ROWS"): "a JAX mesh axis name",
    ("lam_tpu.parallel.pcg2d", "COLS"): "a JAX mesh axis name",
    ("lam_tpu.parallel.pcg2d_symm", "AXES"): "the JAX mesh's axis names",
    ("lam_tpu.parallel.pcg2d_symm", "ROWS"): "a JAX mesh axis name",
    ("lam_tpu.parallel.pcg2d_symm", "COLS"): "a JAX mesh axis name",
}


def _modules():
    names = ["lam_tpu"] + [m.name for m in pkgutil.walk_packages(
        lam_tpu.__path__, "lam_tpu.")]
    # the compiled host library has no Python names to port
    return [name for name in names if name != "lam_tpu.liblam_native"]


def _public(name):
    mod = importlib.import_module(name)
    names = set(getattr(mod, "__all__", ()))
    for key, value in vars(mod).items():
        if key.startswith("_") or inspect.ismodule(value):
            continue
        if callable(value):
            if getattr(value, "__module__", None) == name:
                names.add(key)
        elif key.isupper():
            names.add(key)
    return names


@pytest.mark.parametrize("name", _modules())
def test_every_public_name_resolves_on_the_port(name):
    port = importlib.import_module("lam_tpu_torch" + name[len("lam_tpu"):])
    missing = {(name, key) for key in _public(name)
               if not hasattr(port, key)}
    assert missing == {k for k in UNPORTED if k[0] == name}


def test_the_allow_list_names_only_what_lam_tpu_has():
    for name, key in UNPORTED:
        assert key in _public(name), (name, key)
        assert UNPORTED[name, key]


@pytest.mark.parametrize("statement", [
    "from lam_tpu_torch.solver import (CGResult, cg_solve, cg_solve_block, "
    "cg_solve_ir, DenseOperator, LinearOperator, ConjugateGradient, "
    "oracle_cg)",
    "from lam_tpu_torch.parallel import make_mesh, ShardedDenseOperator",
    "import lam_tpu_torch.parallel",
    "import lam_tpu_torch; import lam_tpu_torch.parallel",
    "from lam_tpu_torch.ops.gemv import (pack_tri_host, pack_rect_host, "
    "tri_tile_count, padded_tri_tile_count, quantize_lo_tiles, "
    "quantize_fq_tiles, SYMM_TB, DF64_SYMM_TB, Q16_P, TILE_M, TILE_K)",
    "from lam_tpu_torch.solver.operators import padded_size, PAD_MULTIPLE",
    "from lam_tpu_torch.parallel.pcg import ROWS_AXIS",
    "from lam_tpu_torch.parallel.pcg_symm import ROWS_AXIS"])
def test_imports_in_a_fresh_interpreter(statement):
    """Each import alone, in a new interpreter, without JAX."""
    code = f"{statement}\nimport sys\nassert 'jax' not in sys.modules"
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120, cwd=root)
    assert proc.returncode == 0, proc.stderr


def test_the_layout_names_are_lam_tpus():
    from lam_tpu.ops import gemv as jgemv
    from lam_tpu.solver import operators as jops

    from lam_tpu_torch.ops import gemv
    from lam_tpu_torch.parallel import pcg, pcg_symm
    from lam_tpu_torch.solver import operators
    for key in ("SYMM_TB", "DF64_SYMM_TB", "Q16_P", "TILE_M", "TILE_K"):
        assert getattr(gemv, key) == getattr(jgemv, key), key
    assert operators.PAD_MULTIPLE == jops.PAD_MULTIPLE
    assert operators.padded_size(1000) == jops.padded_size(1000)
    assert pcg.ROWS_AXIS == pcg_symm.ROWS_AXIS == "rows"
