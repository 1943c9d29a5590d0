"""Hand-written Hopper kernels with their plain PyTorch versions, and the
packed-storage layout they read.

One registry of launch counters covers every kernel module: `KERNELS`
(the wrappers, each counting its launches in `.launches`), `PLAIN` (the
plain versions, each counting its calls in `.calls`), `reset_counters()`
and `counters()`.
"""

from lam_tpu_torch.ops import gemv, stencil

KERNELS = gemv.KERNELS + stencil.KERNELS
PLAIN = gemv.PLAIN + stencil.PLAIN


def reset_counters():
    for fn in KERNELS:
        fn.launches = 0
    for fn in PLAIN:
        fn.calls = 0


def counters():
    """{name: count} of kernel launches and plain-version calls."""
    out = {fn.__name__: fn.launches for fn in KERNELS}
    out.update({fn.__name__: fn.calls for fn in PLAIN})
    return out


reset_counters()
