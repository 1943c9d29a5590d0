"""The 5-point Laplacian stencil of the heat-equation demo.

Replaces the Pallas kernel of lam_tpu/ops/stencil.py:

    laplace5_f32_halo  <- laplace5_f32_halo  (stencil.py:92)
    laplace5_f32       <- laplace5_f32       (stencil.py:145, zero edges)

On a padded (H, W) f32 grid it computes the masked matvec

    y[i,j] = 4 p[i,j] - p[i-1,j] - p[i+1,j] - p[i,j-1] - p[i,j+1]

on the valid interior (rows < nrows_valid, columns < nxi) and 0 in the
padding, with the caller's `up_edge`/`dn_edge` rows above row 0 and below
row H-1 and zeros beyond the side columns, and returns it together with
p . y, the CG loop's fused dot (solver/cg.py matvec_dot contract).

On a CUDA tensor `laplace5_f32_halo` launches the hand-written Hopper
kernel of csrc/stencil.cu (built at first use by `_build`) on the current
stream, or raises. On a CPU tensor, and only there, it runs the plain
PyTorch version beside it. The wrapper counts its launches in
`.launches`, the plain version its calls in `.calls`
(lam_tpu_torch.ops.reset_counters, counters).
"""

from __future__ import annotations

import torch

from lam_tpu_torch.ops.gemv import _raise_on

_LANES = 128    # W is padded to a multiple of this (lam_tpu's lane width)
_SUBLANES = 8   # a small shard's row tile is a multiple of this


def padded_hw(nyi, nxi, tbr_target=256, row_groups=1):
    """(H, W, tbr): grid padded so W % 128 == 0 and H % (row_groups *
    tbr) == 0 (row_groups > 1 = shards of a row-sharded grid, each a
    whole number of tiles). The same numbers as lam_tpu's."""
    W = -(-nxi // _LANES) * _LANES
    per = -(-nyi // row_groups)
    if per >= tbr_target:
        tbr = tbr_target
    else:  # small shards: one sublane-aligned block each
        tbr = -(-per // _SUBLANES) * _SUBLANES
    H = -(-nyi // (row_groups * tbr)) * (row_groups * tbr)
    return H, W, tbr


def laplace5_f32_halo_plain(p2d, up_edge, dn_edge, nrows_valid, *, nxi):
    """Plain PyTorch (y, p . y): the terms taken in lam_tpu's order
    (stencil.py:86), 4p - north - south - west - east, each rounded to
    f32, then the masked f32 sum of p * y."""
    laplace5_f32_halo_plain.calls += 1
    y = laplace5_masked(p2d, up_edge, dn_edge, nrows_valid, nxi)
    return y, torch.sum(p2d * y)


def laplace5_masked(p2d, up_edge, dn_edge, nrows_valid, nxi):
    """The masked 5-point Laplacian y alone, in p2d's dtype, with the
    kernel's order of terms: the plain version's y, and the f64 stencil of
    the row-sharded heat path's refinement (lam_tpu/apps/heat.py:199-212),
    which has no kernel in lam_tpu either."""
    H, W = p2d.shape
    north = torch.cat([up_edge, p2d[:-1]], dim=0)
    south = torch.cat([p2d[1:], dn_edge], dim=0)
    zcol = torch.zeros((H, 1), dtype=p2d.dtype, device=p2d.device)
    west = torch.cat([zcol, p2d[:, :-1]], dim=1)
    east = torch.cat([p2d[:, 1:], zcol], dim=1)
    rows = torch.arange(H, device=p2d.device)[:, None]
    cols = torch.arange(W, device=p2d.device)[None, :]
    mask = (rows < nrows_valid) & (cols < nxi)
    return torch.where(mask, 4.0 * p2d - north - south - west - east, 0.0)


def _check(what, p2d, up_edge, dn_edge, tbr):
    """(H, W) of the grid; raises ValueError for anything the kernel does
    not take: a grid that is not a whole number of (tbr, 128) tiles (as
    lam_tpu), or tensors that are not contiguous f32 on one device, of
    shapes (H, W), (1, W), (1, W), 16-byte aligned on the card."""
    if p2d.dim() != 2:
        raise ValueError(f"{what}: p2d has shape {tuple(p2d.shape)}")
    H, W = p2d.shape
    if H % tbr or W % _LANES:
        raise ValueError(f"padded grid ({H}, {W}) must be a multiple of "
                         f"(tbr={tbr}, {_LANES})")
    for name, x, shape in (("p2d", p2d, (H, W)), ("up_edge", up_edge, (1, W)),
                           ("dn_edge", dn_edge, (1, W))):
        if tuple(x.shape) != shape:
            raise ValueError(f"{what}: {name} has shape {tuple(x.shape)}, "
                             f"expected {shape}")
        if x.dtype != torch.float32:
            raise ValueError(f"{what}: {name} must be float32, got {x.dtype}")
        if x.device != p2d.device:
            raise ValueError(f"{what}: {name} is on {x.device}, expected "
                             f"{p2d.device}")
        if not x.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
        if x.is_cuda and x.data_ptr() % 16:
            raise ValueError(f"{what}: {name} must be 16-byte aligned (the "
                             "kernel reads it as 16-byte vectors)")
    if p2d.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {p2d.device}")
    return H, W


def laplace5_f32_halo(p2d, up_edge, dn_edge, nrows_valid, *, nxi, tbr):
    """(y, p . y) for the masked 5-point Laplacian on a padded block.

    p2d: (H, W) f32 with H % tbr == 0, W % 128 == 0, and zeros outside
    the valid interior (leading `nrows_valid` rows x nxi cols).
    up_edge/dn_edge: (1, W) rows adjacent to the block's top/bottom:
    zeros at the true boundary, a neighbour shard's edge rows when the
    grid is row-sharded. nrows_valid: an int. Returns y (H, W) with the
    same zero-padding invariant and p . y as a 0-dim f32 tensor on the
    grid's device. `tbr` is lam_tpu's row tile: checked, not used for
    tiling (the kernel picks its own)."""
    return _laplace5(laplace5_f32_halo, laplace5_f32_halo_plain,
                     "lam_laplace5_f32_halo", p2d, up_edge, dn_edge,
                     nrows_valid, nxi, tbr)


def _laplace5(wrapper, plain, entry, p2d, up_edge, dn_edge, nrows_valid, nxi,
              tbr):
    """(y, p . y) for `wrapper`: checks, then `plain` on a CPU tensor or the
    C entry point `entry` of csrc/stencil.cu on the current stream, which
    counts a launch on `wrapper` and raises if it failed."""
    what = wrapper.__name__
    H, W = _check(what, p2d, up_edge, dn_edge, tbr)
    nrows = min(max(int(nrows_valid), 0), H)
    ncols = min(max(int(nxi), 0), W)
    if p2d.device.type == "cpu":
        return plain(p2d, up_edge, dn_edge, nrows, nxi=ncols)
    from lam_tpu_torch.ops._build import library
    lib = library()
    y = torch.empty_like(p2d)
    dot = torch.empty((), dtype=torch.float32, device=p2d.device)
    partials = torch.empty(lib.lam_laplace5_blocks(H, W), dtype=torch.float64,
                           device=p2d.device)
    with torch.cuda.device(p2d.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = getattr(lib, entry)(
            p2d.data_ptr(), up_edge.data_ptr(), dn_edge.data_ptr(),
            y.data_ptr(), partials.data_ptr(), dot.data_ptr(), H, W, nrows,
            ncols, stream)
    wrapper.launches += 1
    _raise_on(what, code)
    return y, dot


def laplace5_f32(p2d, *, nyi, nxi, tbr):
    """Single-device form: zero edges, `nyi` valid rows (see
    laplace5_f32_halo)."""
    zrow = torch.zeros((1, p2d.shape[1]), dtype=torch.float32,
                       device=p2d.device)
    return laplace5_f32_halo(p2d, zrow, zrow, nyi, nxi=nxi, tbr=tbr)


KERNELS = (laplace5_f32_halo,)
PLAIN = (laplace5_f32_halo_plain,)
