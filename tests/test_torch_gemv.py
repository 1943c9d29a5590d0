"""The port's symmetric matvecs (plain PyTorch on the CPU) against lam_tpu's
packed Pallas kernels, run in interpret mode as tests/test_kernels.py runs
them, and against the float64 oracle a @ p. n=1024, tb=512: 3 packed tiles.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lam_tpu.ops import gemv as jgemv
from lam_tpu_torch.ops import _build, gemv, layout
from lam_tpu_torch.precision import (df_add, df_mul, split_f64,
                                     split_f64_host, two_prod, two_sum)

N, TB = 1024, 512


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the suite runs several test processes on shared cores: torch's own
    # thread pool would oversubscribe them
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _system(seed):
    rng = np.random.default_rng(seed)
    m = rng.uniform(-1, 1, size=(N, N))
    a = m + m.T
    p = rng.uniform(-1, 1, size=N)
    hi, lo = (layout.pack_tri_host(x, TB) for x in split_f64_host(a))
    ph, pl = split_f64_host(p)
    return a, hi, lo, ph, pl


def _rel(y, ref):
    return np.linalg.norm(y - ref) / np.linalg.norm(ref)


def test_gemv_f32_symm_matches_lam_tpu():
    _, hi, _, ph, _ = _system(31)
    gemv.reset_counters()
    y = gemv.gemv_f32_symm(torch.from_numpy(hi), torch.from_numpy(ph))
    ref = np.asarray(jgemv.gemv_f32_symm(jnp.asarray(hi), jnp.asarray(ph),
                                         packed=True))
    assert y.dtype == torch.float32 and y.shape == (N,)
    # both exact f32 products summed in f32, in different orders
    assert _rel(y.numpy().astype(np.float64), ref.astype(np.float64)) <= 1e-6
    # a CPU tensor takes the plain version; no kernel launch
    counts = gemv.counters()
    assert counts.pop("gemv_f32_symm_plain") == 1
    assert set(counts.values()) == {0}
    assert set(counts) >= {"gemv_f32_symm", "gemv_df64_symm",
                           "gemv_df64_symm_plain"}


@pytest.mark.parametrize("comp", [None, "nolow", "full"])
def test_gemv_df64_symm_f64_quality_and_lam_tpu_parity(comp):
    a, hi, lo, ph, pl = _system(32)
    yh, yl = gemv.gemv_df64_symm(*map(torch.from_numpy, (hi, lo, ph, pl)),
                                 comp=comp)
    assert yh.dtype == yl.dtype == torch.float32
    y = yh.numpy().astype(np.float64) + yl.numpy()
    oracle = a @ (ph.astype(np.float64) + pl)
    # f64 accumulation, returned as an f32 (hi, lo) split: ~2^-48
    assert _rel(y, oracle) <= 1e-13
    jh, jl = jgemv.gemv_df64_symm(*map(jnp.asarray, (hi, lo, ph, pl)),
                                  comp=comp, packed=True)
    yj = np.asarray(jh, np.float64) + np.asarray(jl, np.float64)
    # XLA:CPU excess precision weakens lam_tpu's compensation on the CPU
    # (tests/test_kernels.py:186-190), hence 1e-6 and not bitwise
    assert _rel(y, yj) <= 1e-6


@pytest.mark.parametrize("shape,n", [((10 * 384, 384), 768),
                                     ((10 * 128, 128), 520),
                                     ((9 * 128 + 1, 128), 512),
                                     ((4 * 128, 128), 512)])
def test_geometry_rejections_match_lam_tpu(shape, n):
    a = np.zeros(shape, np.float32)
    p = np.zeros(n, np.float32)
    with pytest.raises(ValueError) as ref:
        jgemv.gemv_f32_symm(jnp.asarray(a), jnp.asarray(p), packed=True)
    with pytest.raises(ValueError) as mine:
        gemv.gemv_f32_symm(torch.from_numpy(a), torch.from_numpy(p))
    assert str(mine.value) == str(ref.value)
    with pytest.raises(ValueError) as ref:
        jgemv.gemv_df64_symm(*map(jnp.asarray, (a, a, p, p)), packed=True)
    with pytest.raises(ValueError) as mine:
        gemv.gemv_df64_symm(*map(torch.from_numpy, (a, a, p, p)))
    assert str(mine.value) == str(ref.value)


def test_wrappers_validate_inputs():
    _, hi, lo, ph, pl = _system(33)
    h, l_, p, q = map(torch.from_numpy, (hi, lo, ph, pl))
    with pytest.raises(ValueError, match="float32"):
        gemv.gemv_f32_symm(h.double(), p)
    with pytest.raises(ValueError, match="contiguous"):
        gemv.gemv_f32_symm(h, torch.from_numpy(np.repeat(ph, 2))[::2])
    with pytest.raises(ValueError, match="comp"):
        gemv.gemv_df64_symm(h, l_, p, q, comp="defer")
    # a (tb, tb) lo tile is the broadcast mode; any other shape is refused
    # with lam_tpu's message (lam_tpu/ops/gemv.py:1001-1004)
    gemv.reset_counters()
    gemv.gemv_df64_symm(h, l_[:TB], p, q)
    assert gemv.counters()["gemv_df64_symm_bcast_plain"] == 1
    with pytest.raises(ValueError, match="single .* broadcast tile"):
        gemv.gemv_df64_symm(h, l_[:2 * TB], p, q)
    with pytest.raises(ValueError, match="device"):
        gemv.gemv_f32_symm(h.to("meta"), p.to("meta"))


def test_precision_helpers_are_exact():
    rng = np.random.default_rng(34)
    x = torch.from_numpy(rng.standard_normal(4096))
    hi, lo = split_f64(x)
    assert torch.equal(hi, x.float())
    # the pair keeps 48 of the 53 bits
    assert float(((hi.double() + lo.double() - x) / x).abs().max()) \
        <= 2.0 ** -47
    a, b = (torch.from_numpy(rng.standard_normal(4096).astype(np.float32))
            for _ in range(2))
    s, e = two_sum(a, b)
    assert torch.equal(s.double() + e.double(), a.double() + b.double())
    p, e = two_prod(a, b)
    assert torch.equal(p.double() + e.double(), a.double() * b.double())
    # float-float add and multiply of the (hi, lo) splits: ~2^-44
    x2 = torch.from_numpy(rng.standard_normal(4096))
    y = split_f64(x2)
    for op, ref, scale in ((df_add, x + x2, x.abs() + x2.abs()),
                           (df_mul, x * x2, (x * x2).abs())):
        zh, zl = op((hi, lo), y)
        err = (zh.double() + zl.double() - ref).abs() / scale
        assert float(err.max()) <= 2.0 ** -44


def test_build_reports_nvcc_failure(tmp_path, monkeypatch):
    nvcc = tmp_path / "nvcc"
    nvcc.write_text("#!/bin/sh\necho 'error: no sm_90a here' >&2\nexit 3\n")
    nvcc.chmod(0o755)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="no sm_90a here"):
        _build.build(nvcc=str(nvcc))
    assert not list((tmp_path / "build").glob("*.so"))


def test_build_names_library_by_source_hash(tmp_path, monkeypatch):
    src = tmp_path / "k.cu"
    src.write_text("// one\n")
    first = _build.library_path([src])
    assert first == _build.library_path([src])
    src.write_text("// two\n")
    assert _build.library_path([src]) != first
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
