"""The reference: the SPD generator, the plain CG, the roofline counts."""

import numpy as np
import pytest
import torch

from cgbench.reference import cg as ref_cg
from cgbench.reference import random_spd, roofline

CFG = {"n": 96, "eigenvalue_scale": 3.5}


def _matrix(seed, n=96):
    gen = random_spd.generator(seed, torch.device("cpu"))
    return random_spd.make_matrix(dict(CFG, n=n), gen)


def test_spectrum_is_the_challenge_law():
    seed = 2**31 + 77  # the driver's seeds pass 32 signed bits
    a = _matrix(seed)
    gen = random_spd.generator(seed, torch.device("cpu"))
    u = torch.rand(96, generator=gen, dtype=torch.float64)
    want = torch.sort(torch.exp(3.5 * (2.0 * u - 1.0))).values
    got = torch.linalg.eigvalsh(a)
    assert torch.allclose(got, want, rtol=1e-12, atol=0)
    assert float(got.min()) >= np.exp(-3.5) and float(got.max()) <= np.exp(3.5)


def test_matrix_is_symmetric_to_the_bit_and_not_diagonal():
    a = _matrix(5, n=5000 // 50)
    assert torch.equal(a, a.T)
    off = a - torch.diag(torch.diagonal(a))
    assert float(off.abs().max()) > 1e-3


def test_symmetrize_blocks_past_one_block(monkeypatch):
    monkeypatch.setattr(random_spd, "_BLOCK", 7)
    a = _matrix(3, n=40)
    assert torch.equal(a, a.T)


def test_same_seed_same_bits_other_seed_other_bits():
    assert torch.equal(_matrix(11), _matrix(11))
    assert not torch.equal(_matrix(11), _matrix(12))
    gen = random_spd.generator(11, torch.device("cpu"))
    random_spd.make_matrix(CFG, gen)
    pool = random_spd.make_rhs_pool(CFG, 5, gen)
    assert pool.shape == (5, 96) and pool.dtype == np.float64
    assert pool.min() >= -1.0 and pool.max() <= 1.0


def test_reference_cg_reaches_the_tolerance_per_column():
    a = _matrix(4)
    b = torch.rand((96, 3), dtype=torch.float64) * 2 - 1
    x, k, conv = ref_cg.cg(a, b, 1e-9, 10000)
    rel = (torch.linalg.vector_norm(b - a @ x, dim=0)
           / torch.linalg.vector_norm(b, dim=0))
    assert bool(conv.all()) and float(rel.max()) < 2e-9
    assert all(0 < int(v) <= 96 * 2 for v in k)


def test_reference_cg_stops_at_max_iters_unconverged():
    a = _matrix(4)
    b = torch.ones((96, 1), dtype=torch.float64)
    _, k, conv = ref_cg.cg(a, b, 1e-9, 3)
    assert int(k[0]) == 3 and not bool(conv[0])


F32 = {"element_bytes": 4, "diagonal_bytes": 0, "vector_bytes": 4,
       "peak": "f32"}
Q16 = {"element_bytes": 2, "diagonal_bytes": 4, "vector_bytes": 4,
       "peak": "f32"}
DF64 = {"element_bytes": 8, "diagonal_bytes": 0, "vector_bytes": 8,
        "peak": "f64"}
FQ = {"element_bytes": 6, "diagonal_bytes": 8, "vector_bytes": 8,
      "peak": "f64"}


@pytest.mark.parametrize("mv, hand", [
    (F32, 4 * (1 + 2 + 3) + 4 * 3 * 2),      # lower triangle with diagonal
    (Q16, 2 * (1 + 2) + 4 * 3 + 4 * 3 * 2),  # strict lower + f32 diagonal
    (DF64, 8 * (1 + 2 + 3) + 8 * 3 * 2),
    (FQ, 6 * (1 + 2) + 8 * 3 + 8 * 3 * 2),
])
def test_matvec_bytes_against_hand_sums(mv, hand):
    # n = 3: the lower triangle has 1 + 2 + 3 elements, 1 + 2 below the
    # diagonal
    assert roofline.matvec_bytes(3, mv) == hand


def test_bound_at_the_cells_sizes_is_set_by_bytes():
    n = 40000
    assert roofline.matvec_flops(n) == 2 * n * n
    for mv in (F32, Q16, DF64, FQ):
        want = roofline.matvec_bytes(n, mv) / roofline.HBM_BYTES_PER_S
        assert roofline.matvec_bound_s(n, mv) == want
    # kernel #1's 3.20 GB of work at N=40000: 0.955 ms
    assert abs(roofline.matvec_bound_s(n, F32) - 0.9553e-3) < 1e-6
