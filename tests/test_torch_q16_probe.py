"""The port's q16 probes (lam_tpu_torch/ops/probe.py, the tool
lam_tpu_torch/tools/q16_probe.py) against lam_tpu's probe scripts, on the
CPU.

scripts/q16_probe{,2,3,4}.py are imported by path and their Pallas kernels
run unchanged inside `pltpu.force_tpu_interpret_mode()`, at n = 2048 (tb =
512: 10 tiles, P = 1) and n = 2048 at tb = 1024 (3 tiles). Each script
result is computed once per module (about a second a call). The inputs: a
random int16 plane (full range) against random power-of-two scales and a
random p, made with numpy. Tolerances: 1e-6 relative l2 for every walk
(f32 sums in other orders; `split` rounds p * s to bf16 on both sides);
the plane, the bit-trick dequantization and the closed forms exactly.

The two controls of ops/probe.py (`gemv_df64_rows`, kernel 6's function on
the dense_rows walk; `gemv_q16_symm_slab_twopass`, kernel 16's on the
two-pass walk) take their plain versions on the CPU: against lam_tpu's
`gemv_df64_cols` and `gemv_q16_symm_slab` (interpret mode; 1e-6, and the
df64 one to an f64 oracle at 1e-13) and bit for bit against the port's
kernel wrappers, whose plain versions compute the same.
"""

import importlib.util
import pathlib
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from lam_tpu.ops import gemv as jgemv
from lam_tpu_torch import ops
from lam_tpu_torch.ops import gemv, probe
from lam_tpu_torch.parallel import pcg_symm
from lam_tpu_torch.precision import split_f64_host
from lam_tpu_torch.tools import q16_probe as tool

ROOT = pathlib.Path(__file__).resolve().parent.parent
N = 2048


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _script(name):
    """scripts/<name>.py as a module (q16_probe3/4 import q16_probe2 from
    the scripts directory)."""
    if name in sys.modules:
        return sys.modules[name]
    scripts = str(ROOT / "scripts")
    if scripts not in sys.path:
        sys.path.insert(0, scripts)
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def _rel(y, ref):
    y, ref = np.asarray(y, np.float64), np.asarray(ref, np.float64)
    return np.linalg.norm(y - ref) / np.linalg.norm(ref)


def _random_plane(tb, seed):
    """A walk-order plane of random int16 tiles against random power-of-two
    scales, the walk tables and a random p."""
    rng = np.random.default_rng(seed)
    it, kt = (np.asarray(x) for x in jgemv._symm_tables(N // tb))
    T = len(it)
    q1 = rng.integers(-32767, 32768, (T * tb, tb)).astype(np.int16)
    sc = (2.0 ** -rng.integers(8, 20, T)).astype(np.float32)
    p = rng.standard_normal(N).astype(np.float32)
    return q1, sc, it.astype(np.int32), kt.astype(np.int32), p


@pytest.fixture(scope="module")
def script_results():
    """Each script kernel's result on the random planes, computed once."""
    p1, p2, p4 = (_script(n) for n in ("q16_probe", "q16_probe2",
                                        "q16_probe4"))
    out = {}
    q1, sc, it, kt, p = _random_plane(512, seed=91)
    args = (jnp.asarray(q1), jnp.asarray(sc), jnp.asarray(it),
            jnp.asarray(kt), jnp.asarray(p))
    with pltpu.force_tpu_interpret_mode():
        out["magic"] = p1.gemv_pair(p1.to_i32(args[0]), *args[1:],
                                    magic=True)
        out["sub8"] = p2.gemv_q16_multi(*args, P=1, sub=8)
        for mode in ("split", "hi", "hybrid"):
            out[mode] = p4.gemv_q16_mxu(*args, P=1, mode=mode)
        out["convert"] = p1._micro_pass(p1._convert_kernel, args[2], args[3],
                                        args[0], 512, 512, jnp.float32)
    q1, sc, _, _, p = _random_plane(1024, seed=92)
    out["tb1024"] = jgemv.gemv_q16_symm(jnp.asarray(q1), jnp.asarray(sc),
                                        jnp.asarray(p))
    return {k: np.asarray(v) for k, v in out.items()}


# -- the plane and the bit trick ----------------------------------------------

@pytest.mark.parametrize("tb", [512, 1024])
@pytest.mark.parametrize("padded", [False, True])
def test_tridiag_plane_is_the_scripts(tb, padded):
    """tridiag_q1 is byte-equal to build_q1 of q16_probe.py (unpadded) and
    q16_probe2.py (padded to 8 tiles), plane, scales and tables."""
    if padded:
        ref = _script("q16_probe2").build_q1(N, tb)[:4]
    else:
        ref = _script("q16_probe").build_q1(N, tb)
    got = probe.tridiag_q1(N, tb, pad_to=8 if padded else None, device="cpu")
    for g, r in zip(got, ref):
        r = np.asarray(r)
        assert g.numpy().dtype == r.dtype and g.shape == r.shape
        assert g.numpy().tobytes() == r.tobytes()


def test_magic_dequant_equals_conversion_for_every_int16():
    q = torch.arange(-32768, 32768, dtype=torch.int32).to(torch.int16)
    got = probe.magic_f32(q)
    assert got.dtype == torch.float32
    assert torch.equal(got, q.to(torch.float32))


# -- each plain version against its script kernel -----------------------------

WALKS = {"magic": probe.gemv_q16_symm_magic, "sub8": probe.gemv_q16_symm_sub8,
         "split": probe.gemv_q16_symm_split, "hi": probe.gemv_q16_symm_hi,
         "hybrid": probe.gemv_q16_symm_hybrid,
         "tb1024": probe.gemv_q16_symm_tb1024,
         "sub8_twopass": probe.gemv_q16_symm_sub8_twopass,
         "split_twopass": probe.gemv_q16_symm_split_twopass,
         "hi_twopass": probe.gemv_q16_symm_hi_twopass,
         "hybrid_twopass": probe.gemv_q16_symm_hybrid_twopass}


@pytest.mark.parametrize("name", list(WALKS))
def test_walk_matches_script_kernel(name, script_results):
    """Each walk (and the two-pass controls of sub8, split, hi and hybrid)
    against its script kernel."""
    tb = 1024 if name == "tb1024" else 512
    q1, sc, _, _, p = _random_plane(tb, seed=92 if tb == 1024 else 91)
    probe.reset_counters()
    y = WALKS[name](torch.from_numpy(q1), torch.from_numpy(sc),
                    torch.from_numpy(p))
    assert y.dtype == torch.float32 and y.shape == (N,)
    assert _rel(y.numpy(),
                script_results[name.removesuffix("_twopass")]) <= 1e-6
    counts = probe.counters()
    assert counts.pop(f"gemv_q16_symm_{name}_plain") == 1
    assert set(counts.values()) == {0}


@pytest.mark.parametrize("seed", [91, 95])
def test_split_control_gives_the_split_walks_result(seed):
    """The two-pass control of split computes split's function: its plain
    version equals split's bit for bit (on the card, the kernels' bits)."""
    args = [torch.from_numpy(x) for x in _random_plane(512, seed)[::4]]
    args.insert(1, torch.from_numpy(_random_plane(512, seed)[1]))
    assert torch.equal(probe.gemv_q16_symm_split_twopass(*args),
                       probe.gemv_q16_symm_split(*args))


def test_split_by_bits_model_for_every_int16():
    """A numpy model of the split that the strip walk's tensor-core
    consumers make by bits (bf16x8_split_by_bits, on a staged vector or on
    raw ldmatrix fragments): for every int16 q, a = f32 of (q ^ 0x8000) |
    0x4B000000 less 2^23 + 2^15 equals q, ah = a rounded to bf16 (nearest
    even) and al = a - ah in f32 hold a exactly, al's f32 has a zero lower
    half (its bf16 is its top half), and ah + al in f32 is a (hybrid's
    direct term takes a by bits for the control's ah + al)."""
    q = np.arange(-32768, 32768, dtype=np.int32)
    u = ((q & 0xFFFF) ^ 0x8000).astype(np.uint32)
    a = (u | np.uint32(0x4B000000)).view(np.float32) - np.float32(8421376.0)
    assert np.array_equal(a, q.astype(np.float32))
    bits = a.view(np.uint32)
    ah = ((bits + np.uint32(0x7FFF) + ((bits >> 16) & 1))
          & np.uint32(0xFFFF0000)).view(np.float32)
    assert np.array_equal(
        ah, torch.from_numpy(a).to(torch.bfloat16).float().numpy())
    al = ah.dtype.type(0) + (a - ah)
    assert al.dtype == np.float32
    assert not np.any(al.view(np.uint32) & np.uint32(0xFFFF))
    assert np.array_equal(ah.astype(np.float64) + al, q.astype(np.float64))
    assert np.array_equal(ah + al, a)


def test_split_rounds_only_the_operand():
    """split stands apart from the exact walk by the bf16 class: it rounds
    p * s to bf16 (and nothing else)."""
    q1, sc, _, _, p = _random_plane(512, seed=91)
    args = (torch.from_numpy(q1), torch.from_numpy(sc), torch.from_numpy(p))
    gap = _rel(probe.gemv_q16_symm_split(*args).numpy(),
               probe.gemv_q16_symm_hi(*args).numpy())
    assert 1e-5 < gap <= 1e-2


def test_convert_checksum_matches_script_kernel(script_results):
    """The converted sum equals the sum of _convert_kernel's (tb, 128) f32
    accumulator (exact on both sides at this size) and the integer sum."""
    q1 = _random_plane(512, seed=91)[0]
    got = probe.convert_f32_sum(torch.from_numpy(q1))
    assert got.dtype == torch.float64
    assert float(got) == script_results["convert"].astype(np.float64).sum()
    assert float(got) == float(q1.astype(np.int64).sum())
    assert int(probe.stream_i16(torch.from_numpy(q1))) == int(
        q1.astype(np.int64).sum())


# -- closed forms, the tool ---------------------------------------------------

@pytest.mark.parametrize("variant", sorted(tool.WALKS) + sorted(tool.STREAMS))
def test_plain_closed_form(variant):
    """Every variant's plain version on the probes' plane: y + 2p = 4 (3 at
    both ends) exactly; the streams' sums their closed form."""
    tb = 1024 if "1024" in variant else 512
    rows = tool._size(lambda line: None, N, tb, 8, [variant], 1,
                      torch.device("cpu"))
    assert [r["variant"] for r in rows] == [variant]
    assert rows[0]["ms"] is None


@pytest.mark.parametrize("k", ["1", "2", "3", "4"])
def test_tool_cli_on_the_cpu(k, capsys):
    assert tool.main(["--probe", k, "--n", str(N), "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert f"probe {k} (scripts/" in out
    rows = [line for line in out.splitlines() if "closed form ok" in line]
    assert len(rows) == sum(len(v) for *_, v in tool.PROBES[int(k)])


def test_tool_refuses_cuda_without_a_card():
    with pytest.raises(RuntimeError, match="cuda"):
        tool.main(["--probe", "1", "--n", str(N), "--device", "cuda"])
    with pytest.raises(RuntimeError, match="cuda"):
        tool.run((1,), N, 1, "cuda")


def test_wrappers_refuse_what_the_kernels_do_not_take():
    q1, sc, _, _, p = (torch.from_numpy(x) for x in _random_plane(512, 93))
    with pytest.raises(ValueError, match="int16"):
        probe.gemv_q16_symm_magic(q1.float(), sc, p)
    with pytest.raises(ValueError, match="tb=1024"):
        probe.gemv_q16_symm_tb1024(q1, sc, p)
    q1k, sck, _, _, pk = (torch.from_numpy(x)
                          for x in _random_plane(1024, 94))
    for fn in (probe.gemv_q16_symm_magic, probe.gemv_q16_symm_sub8,
               probe.gemv_q16_symm_split, probe.gemv_q16_symm_hi,
               probe.gemv_q16_symm_hybrid, probe.gemv_q16_symm_split_twopass,
               probe.gemv_q16_symm_hi_twopass,
               probe.gemv_q16_symm_hybrid_twopass):
        with pytest.raises(ValueError, match="tb=512"):
            fn(q1k, sck, pk)
    strided = torch.zeros(q1.shape[0], 2 * q1.shape[1],
                          dtype=torch.int16)[:, ::2]
    with pytest.raises(ValueError, match="contiguous"):
        probe.gemv_q16_symm_sub8(strided, sc, p)
    with pytest.raises(ValueError, match="table shape"):
        probe.gemv_q16_symm_hi(q1, sc[:-1], p)
    for fn in (probe.stream_i16, probe.convert_f32_sum):
        with pytest.raises(ValueError, match="int16"):
            fn(q1.float())
        with pytest.raises(ValueError, match="contiguous"):
            fn(strided)


def test_new_modules_import_no_jax():
    code = ("import sys; import lam_tpu_torch.ops.probe, "
            "lam_tpu_torch.tools.q16_probe; "
            "print(sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'jaxlib', 'lam_tpu')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"


# -- the controls of kernels 6 and 16 -----------------------------------------

def _control_calls():
    """{name: count} of the controls' launches and plain calls, and of the
    two solver kernels' wrappers and plain versions."""
    counts = probe.counters()
    out = {fn.__name__: counts[fn.__name__] for fn in probe.CONTROLS}
    out.update({f"{fn.__name__}_plain": counts[f"{fn.__name__}_plain"]
                for fn in probe.CONTROLS})
    solver = ops.counters()
    out.update({k: solver[k] for k in (
        "gemv_df64_cols", "gemv_df64_cols_plain", "gemv_q16_symm_slab",
        "gemv_q16_symm_slab_plain")})
    return out


@pytest.mark.parametrize("blk", range(4))
def test_df64_rows_control_matches_lam_tpu(blk):
    rng = np.random.default_rng(40 + blk)
    a = rng.uniform(-1, 1, size=(256, 512))
    p = rng.uniform(-1, 1, size=128)
    (ah, al), (ph, pl) = split_f64_host(a), split_f64_host(p)
    args = [torch.from_numpy(x) for x in (ah, al, ph, pl)]
    probe.reset_counters()
    ops.reset_counters()
    yh, yl = probe.gemv_df64_rows(*args, blk)
    calls = _control_calls()
    assert calls.pop("gemv_df64_rows_plain") == 1
    assert set(calls.values()) == {0}
    y = yh.double().numpy() + yl.double().numpy()
    cols = slice(blk * 128, (blk + 1) * 128)
    oracle = ((ah[:, cols].astype(np.float64) + al[:, cols])
              @ (ph.astype(np.float64) + pl))
    assert _rel(y, oracle) <= 1e-13
    rh, rl = jgemv.gemv_df64_cols(ah, al, ph, pl, blk)
    assert _rel(y, np.asarray(rh, np.float64) + np.asarray(rl)) <= 1e-6
    zh, zl = gemv.gemv_df64_cols(*args, blk)
    assert torch.equal(yh, zh) and torch.equal(yl, zl)


@pytest.mark.parametrize("g,mt", [(1, 2), (2, 2), (3, 1)])
def test_q16_slab_twopass_control_matches_lam_tpu(g, mt):
    tb = 128
    its, kts, lts = pcg_symm._band_tables(g, mt, tb)
    n, ms = 2 * g * mt * tb, 2 * mt * tb
    rng = np.random.default_rng(50 + 10 * g + mt)
    p = rng.standard_normal(n).astype(np.float32)
    for c in range(g):
        it, kt, lt = (x[c].copy() for x in (its, kts, lts))
        T = it.shape[0]
        q1 = rng.integers(-32767, 32768, (T * tb, tb)).astype(np.int16)
        sc = (2.0 ** -rng.integers(8, 20, T)).astype(np.float32)
        args = [torch.from_numpy(x) for x in (q1, sc, p, it, kt, lt)]
        probe.reset_counters()
        ops.reset_counters()
        yd, yt = probe.gemv_q16_symm_slab_twopass(*args, ms=ms)
        calls = _control_calls()
        assert calls.pop("gemv_q16_symm_slab_twopass_plain") == 1
        assert set(calls.values()) == {0}
        assert yd.shape == (ms,) and yt.shape == (n,)
        rd, rt = (np.asarray(x) for x in jgemv.gemv_q16_symm_slab(
            q1, sc, p, it, kt, lt, ms=ms))
        assert _rel(yd.numpy(), rd) <= 1e-6
        assert (_rel(yt.numpy(), rt) <= 1e-6) if np.any(rt) else \
            not torch.any(yt)
        zd, zt = gemv.gemv_q16_symm_slab(*args, ms=ms)
        assert torch.equal(yd, zd) and torch.equal(yt, zt)


def test_controls_refuse_what_their_kernels_refuse():
    a = torch.zeros(256, 512)
    p = torch.zeros(128)
    with pytest.raises(ValueError, match="differ"):
        probe.gemv_df64_rows(a, a[:128], p, p, 0)
    with pytest.raises(ValueError, match="outside"):
        probe.gemv_df64_rows(a, a, p, p, 4)
    with pytest.raises(ValueError, match="float32"):
        probe.gemv_df64_rows(a.double(), a, p, p, 0)
    with pytest.raises(ValueError, match="contiguous"):
        probe.gemv_df64_rows(a.t().contiguous().t(), a, p, p, 0)
    its, kts, lts = pcg_symm._band_tables(2, 1, 128)
    it, kt, lt = (torch.from_numpy(x[0].copy()) for x in (its, kts, lts))
    T = it.shape[0]
    q1 = torch.zeros(T * 128, 128, dtype=torch.int16)
    sc, pv = torch.ones(T), torch.zeros(512)
    with pytest.raises(ValueError, match="int16"):
        probe.gemv_q16_symm_slab_twopass(q1.float(), sc, pv, it, kt, lt,
                                         ms=256)
    with pytest.raises(ValueError, match="table shape"):
        probe.gemv_q16_symm_slab_twopass(q1, sc[:-1], pv, it, kt, lt, ms=256)
    with pytest.raises(ValueError, match="out of range"):
        probe.gemv_q16_symm_slab_twopass(q1, sc, pv, it, it + 1, lt, ms=256)
    probe.reset_counters()
    with pytest.raises(ValueError, match="expected"):
        probe.gemv_q16_symm_slab_twopass(q1, sc, pv.to("meta"), it, kt, lt,
                                         ms=256)
    q1s, scs, _, _, ps = (torch.from_numpy(x)
                          for x in _random_plane(512, 98))
    with pytest.raises(ValueError, match="table shape"):
        probe.gemv_q16_symm_split_twopass(q1s, scs[:-1], ps)
    with pytest.raises(ValueError, match="int16"):
        probe.gemv_q16_symm_split_twopass(q1s.int(), scs, ps)
    assert set(probe.counters().values()) == {0}


@pytest.mark.parametrize("walk", ["split", "split_twopass"])
@pytest.mark.parametrize("case,match", [
    ("dtype", "int16"), ("tb", "tb=512"), ("contiguous", "contiguous"),
    ("scales", "table shape"), ("p-dtype", "float32"),
    ("device", "expected")])
def test_split_walk_and_its_control_refuse_the_same(walk, case, match):
    """split and its two-pass control refuse the same operands, before any
    launch or plain call."""
    _refuse(walk, case, match)


def _refuse(walk, case, match):
    fn = WALKS[walk]
    q1, sc, _, _, p = (torch.from_numpy(x) for x in _random_plane(512, 96))
    q1k, sck, _, _, pk = (torch.from_numpy(x)
                          for x in _random_plane(1024, 97))
    strided = torch.zeros(q1.shape[0], 2 * q1.shape[1],
                          dtype=torch.int16)[:, ::2]
    args = {"dtype": (q1.float(), sc, p), "tb": (q1k, sck, pk),
            "contiguous": (strided, sc, p), "scales": (q1, sc[:-1], p),
            "p-dtype": (q1, sc, p.double()),
            "device": (q1, sc, p.to("meta"))}[case]
    probe.reset_counters()
    with pytest.raises(ValueError, match=match):
        fn(*args)
    assert set(probe.counters().values()) == {0}


@pytest.mark.parametrize("walk", ["hi", "hi_twopass", "hybrid",
                                  "hybrid_twopass"])
@pytest.mark.parametrize("case,match", [
    ("dtype", "int16"), ("tb", "tb=512"), ("contiguous", "contiguous"),
    ("scales", "table shape"), ("p-dtype", "float32"),
    ("device", "expected")])
def test_hi_and_hybrid_walks_and_their_controls_refuse_the_same(walk, case,
                                                                match):
    """hi and hybrid and their two-pass controls refuse the same operands,
    before any launch or plain call (a misaligned p only on the card:
    tests/test_torch_cuda.py)."""
    _refuse(walk, case, match)


@pytest.mark.parametrize("walk", ["sub8", "sub8_twopass"])
@pytest.mark.parametrize("case,match", [
    ("dtype", "int16"), ("tb", "tb=512"), ("contiguous", "contiguous"),
    ("scales", "table shape"), ("p-dtype", "float32"),
    ("device", "expected")])
def test_sub8_walk_and_its_control_refuse_the_same(walk, case, match):
    """sub8 and its two-pass control refuse the same operands, before any
    launch or plain call (a misaligned p only on the card:
    tests/test_torch_cuda.py)."""
    _refuse(walk, case, match)


@pytest.mark.parametrize("walk", ["sub8", "split", "hi", "hybrid"])
def test_walks_and_controls_take_an_unaligned_p_on_the_cpu(walk):
    """The 16-byte alignment of p is asked only of a CUDA tensor: on the
    CPU a p that starts 4 bytes into its buffer gives each walk and its
    control the plain versions' result."""
    q1, sc, _, _, p = (torch.from_numpy(x) for x in _random_plane(512, 99))
    buf = torch.zeros(p.numel() + 1)
    off = buf[1:]
    off.copy_(p)
    assert off.data_ptr() % 16
    y = WALKS[walk](q1, sc, off)
    assert torch.equal(y, WALKS[walk](q1, sc, p))
    assert torch.equal(y, WALKS[f"{walk}_twopass"](q1, sc, off))


def test_controls_stay_out_of_the_solver_registry():
    names = {fn.__name__ for fn in probe.CONTROLS}
    assert names == {"gemv_df64_rows", "gemv_q16_symm_slab_twopass",
                     "gemv_q16_dual_twopass", "gemv_fq_dual_twopass",
                     "gemv_q16_dual_bf16_twopass",
                     "laplace5_f32_halo_twopass",
                     "gemv_q16_symm_sub8_twopass",
                     "gemv_q16_symm_split_twopass",
                     "gemv_q16_symm_hi_twopass",
                     "gemv_q16_symm_hybrid_twopass"}
    assert set(probe.CONTROLS) <= set(probe.PROBES)
    assert not names & {fn.__name__ for fn in ops.KERNELS}
    for fn in probe.CONTROLS:
        fn.launches = 3
    probe.reset_counters()
    assert all(fn.launches == 0 for fn in probe.CONTROLS)
