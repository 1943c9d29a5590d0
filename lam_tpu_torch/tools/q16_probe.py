"""`python -m lam_tpu_torch.tools.q16_probe`: lam_tpu's q16 probes on the
card, the rows of scripts/q16_probe{,2,3,4}.py's main().

    python -m lam_tpu_torch.tools.q16_probe --probe 1|2|3|4|all
        [--n N] [--reps R] [--device cuda|cpu]

Each probe builds the tridiagonal q1 plane of `ops.probe.tridiag_q1` on
the device, then runs its variants (lam_tpu_torch/ops/probe.py):

  1  (q16_probe.py:327)  N=40960: floor, convert, base and magic at
     tb=512; floor, convert and base at tb=1024
  2  (q16_probe2.py:295) N=114688, tb=512, tile count padded to 8: base,
     floor, full sub=1
  3  (q16_probe3.py:83)  N=57344, tb=512: floor, full sub=1, full sub=8;
     N=114688, tb=1024: floor, full; N=114688, tb=512: full sub=8
  4  (q16_probe4.py:227) N=114688, tb=512: floor, vpu, mxu-def, hi,
     split, hybrid

floor is `stream_i16` (the plane read once, no conversion, no products),
convert `convert_f32_sum`, base, full sub=1 and vpu kernel 14's exact walk
(`gemv.gemv_q16_symm`'s exact body; the scripts' P, tiles a TPU grid
step, has no counterpart on the card, and P=8 is kernel 14's blocked
form), mxu-def kernel 14's bf16 engine (`gemv.gemv_q16_symm_bf16`), and
magic, full at tb=1024, full sub=8, hi, split and hybrid the probe walks
of csrc/q16_probe.cu. Every variant is validated before it is timed: with
p = 1, y + 2p must equal 4, and 3 at both ends, exactly (each engine is
exact on these values); the streams' sums must equal the plane's closed
form. A failed check raises.

On the card each variant is timed with CUDA events around `--reps` calls
behind a device spin, `SAMPLES` times in turns with the floor on the same
plane; each row prints the median ms per call, the GB/s of the bytes moved
(the plane's tiles read, the operands, and for a walk the partials written
and read back), its time over the read floor's, and its GB/s over the data
sheet's 3.35 TB/s; the header line is the card's name and power limit
(`nvidia-smi`). `--device cpu` runs the plain versions and times nothing
(give a small `--n`, a multiple of 1024: every size of the probe becomes
n). `--device cuda` with no card raises.
"""

from __future__ import annotations

import argparse
import statistics
import subprocess
import sys
import time

import torch

from lam_tpu_torch.ops import gemv, layout, probe
from lam_tpu_torch.solver.operators import resolve_device

SCRIPTS = {1: "q16_probe.py", 2: "q16_probe2.py", 3: "q16_probe3.py",
           4: "q16_probe4.py"}
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
SAMPLES = 5
SPIN_CYCLES = 6_000_000  # ~3 ms at the H100's clock: covers an enqueue


def _exact(q1, s1, p):
    """Kernel 14's exact body, whatever the engine setting picks."""
    return gemv._q16_symm(gemv.gemv_q16_symm, gemv.gemv_q16_symm_plain,
                          "lam_gemv_q16_symm", q1, s1, p)


# variant -> (the function of (q1, s1, p), partial rows a strip kept apart)
WALKS = {"base": (_exact, 1), "full sub=1": (_exact, 1),
         "vpu": (_exact, 1), "magic": (probe.gemv_q16_symm_magic, 1),
         "full tb=1024": (probe.gemv_q16_symm_tb1024, 1),
         "base tb=1024": (probe.gemv_q16_symm_tb1024, 1),
         "full sub=8": (probe.gemv_q16_symm_sub8, 8),
         "mxu-def": (gemv.gemv_q16_symm_bf16, 1),
         "hi": (probe.gemv_q16_symm_hi, 1),
         "split": (probe.gemv_q16_symm_split, 1),
         "hybrid": (probe.gemv_q16_symm_hybrid, 1)}
STREAMS = {"floor": probe.stream_i16, "convert": probe.convert_f32_sum}

# probe -> [(n, tb, pad_to, [variants])]
PROBES = {
    1: [(40960, 512, None, ["floor", "convert", "base", "magic"]),
        (40960, 1024, None, ["floor", "convert", "base tb=1024"])],
    2: [(114688, 512, 8, ["base", "floor", "full sub=1"])],
    3: [(57344, 512, 8, ["floor", "full sub=1", "full sub=8"]),
        (114688, 1024, 8, ["floor", "full tb=1024"]),
        (114688, 512, 8, ["full sub=8"])],
    4: [(114688, 512, 8, ["floor", "vpu", "mxu-def", "hi", "split",
                          "hybrid"])],
}


def _median_ms(fns, reps):
    """Median CUDA-event time per call of each fn over SAMPLES batches of
    `reps` back-to-back calls, taken in turns, each batch enqueued behind
    a device spin so the host's launch rate cannot gap it."""
    for fn in fns:
        fn()
    torch.cuda.synchronize()
    times = [[] for _ in fns]
    for _ in range(SAMPLES):
        for fn, ts in zip(fns, times):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(SPIN_CYCLES)
            start.record()
            for _ in range(reps):
                fn()
            end.record()
            end.synchronize()
            ts.append(start.elapsed_time(end) / reps)
    return [statistics.median(ts) for ts in times]


def _nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def _stream_sum(q1, tb, nblk):
    """The plane's closed-form sum: 16384 on both off-diagonals of every
    band tile (pad tiles included), once in each sub-diagonal tile."""
    band = q1.shape[0] // tb - layout.tri_tile_count(nblk) + nblk
    return round(1.0 / probe.SCALE) * (band * 2 * (tb - 1) + nblk - 1)


def _check_walk(name, y, p):
    expect = torch.full_like(p, 4.0)
    expect[0] = expect[-1] = 3.0
    if not torch.equal(y + 2.0 * p, expect):
        err = float((y + 2.0 * p - expect).abs().max())
        raise AssertionError(f"q16 probe {name}: closed form failed, "
                             f"max |y + 2p - expect| = {err:.3e}")


def _size(emit, n, tb, pad_to, variants, reps, device):
    nblk = n // tb
    q1, sc, _, _ = probe.tridiag_q1(n, tb, pad_to=pad_to, device=device)
    T = layout.tri_tile_count(nblk)
    p = torch.ones(n, dtype=torch.float32, device=device)
    plane = _nbytes(q1)
    emit(f"-- N={n} tb={tb}: {T} walk tiles (+{q1.shape[0] // tb - T} "
         f"pad), {plane / 2**30:.2f} GiB plane")
    floor = probe.stream_i16
    rows = []
    for name in variants:
        if name in STREAMS:
            fn = STREAMS[name]
            got, want = fn(q1), _stream_sum(q1, tb, nblk)
            if float(got) != want:
                raise AssertionError(f"q16 probe {name}: sum {float(got)} "
                                     f"!= closed form {want}")
            call, nbytes = (lambda fn=fn: fn(q1)), plane
        else:
            fn, sub = WALKS[name]
            y = fn(q1, sc, p)
            _check_walk(name, y, p)
            call = lambda fn=fn: fn(q1, sc, p)  # noqa: E731
            strips = tb // 64  # 64-row strips of a tile (csrc/symm_walk.cuh)
            nbytes = (_nbytes(q1[:T * tb], sc[:T], p, y)
                      + 2 * 4 * T * tb * (1 + strips * sub))
        row = {"n": n, "tb": tb, "variant": name, "bytes": nbytes,
               "ms": None, "floor_ms": None}
        if device.type == "cuda":
            if name == "floor":
                row["ms"] = row["floor_ms"] = _median_ms([call], reps)[0]
            else:
                row["ms"], row["floor_ms"] = _median_ms(
                    [call, lambda: floor(q1)], reps)
            gbs = nbytes / row["ms"] / 1e6
            emit(f"  {name:13s} {row['ms']:9.4f} ms/call  {gbs:6.0f} GB/s  "
                 f"x{row['ms'] / row['floor_ms']:.3f} of the floor's time  "
                 f"{gbs * 1e9 / HBM_BYTES_PER_S:.3f} of 3.35 TB/s  "
                 f"[{nbytes / 1e9:.3f} GB moved]")
        else:
            emit(f"  {name:13s} closed form ok (plain version; time not "
                 f"measured on the cpu)  [{nbytes / 1e9:.3f} GB moved]")
        rows.append(row)
    del q1, sc, p
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return rows


def run(probes=(1, 2, 3, 4), n=None, reps=10, device="cuda", emit=print):
    """Run the probes' variants (validated, then timed on the card); a row
    dict per variant: n, tb, variant, bytes, ms and floor_ms (None on the
    cpu). `n` replaces every size of the probes."""
    device = resolve_device(device)
    rows = []
    for k in probes:
        t0 = time.perf_counter()
        emit(f"probe {k} (scripts/{SCRIPTS[k]})")
        for size, tb, pad_to, variants in PROBES[k]:
            for row in _size(emit, n or size, tb, pad_to, variants, reps,
                             device):
                rows.append({"probe": k, **row})
        emit(f"probe {k}: {time.perf_counter() - t0:.1f} s")
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m lam_tpu_torch.tools.q16_probe")
    ap.add_argument("--probe", default="all",
                    choices=["1", "2", "3", "4", "all"])
    ap.add_argument("--n", type=int, default=None,
                    help="one size for every row (a multiple of 1024); "
                         "default: the scripts' sizes")
    ap.add_argument("--reps", type=int, default=10,
                    help="calls per timed batch")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises with no card) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    if args.n is not None and (args.n <= 0 or args.n % 1024):
        ap.error(f"--n {args.n} must be a positive multiple of 1024")
    if device.type == "cpu" and args.n is None:
        ap.error("--device cpu runs the plain versions: give a small --n")
    if device.type == "cuda":
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip())
    else:
        print("cpu: plain versions, no device times")
    probes = (1, 2, 3, 4) if args.probe == "all" else (int(args.probe),)
    run(probes, args.n, args.reps, device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
