"""The read floor of a q16 plane: a pure stream with a checksum.

    stream_i16  <- scripts/q16_probe.py _floor_kernel (:91, pallas_call
                   :139) and scripts/q16_probe2.py _floor_kernel (:89,
                   :142)

lam_tpu's probes streamed the q16 plane through a kernel that did no
conversion and no products, to measure the DMA floor the q16 kernel is
held to. `stream_i16` does the same on the card: csrc/probe.cu reads the
int16 plane once in 16-byte streaming loads and returns the int64 sum of
its values, which keeps every load live. Timed on a kernel's plane, it
is the card's measured read floor for those bytes, beside the data
sheet's 3.35 TB/s.

It is a measuring tool, not a kernel of the solver's path, so it stays
out of the launch registry of lam_tpu_torch.ops; it counts its launches
in `stream_i16.launches` and its plain version its calls in
`stream_i16_plain.calls` all the same.
"""

from __future__ import annotations

import torch

BLOCKS_PER_SM = 8


def stream_i16_plain(plane):
    """Plain PyTorch checksum: the int64 sum of the plane's values."""
    stream_i16_plain.calls += 1
    return plane.to(torch.int64).sum()


def stream_i16(plane):
    """The int64 sum of a contiguous int16 tensor (any shape, a multiple
    of 8 elements, 16-byte aligned on the card): on a CUDA tensor the
    streaming kernel of csrc/probe.cu, on a CPU tensor the plain
    version."""
    what = "stream_i16"
    if plane.dtype != torch.int16 or not plane.is_contiguous():
        raise ValueError(f"{what}: plane must be a contiguous int16 tensor")
    if plane.numel() == 0 or plane.numel() % 8:
        raise ValueError(f"{what}: {plane.numel()} elements, need a "
                         "positive multiple of 8")
    if plane.device.type == "cpu":
        return stream_i16_plain(plane)
    if plane.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {plane.device}")
    if plane.data_ptr() % 16:
        raise ValueError(f"{what}: plane must be 16-byte aligned")
    from lam_tpu_torch.ops._build import library
    lib = library()
    sms = torch.cuda.get_device_properties(plane.device).multi_processor_count
    blocks = BLOCKS_PER_SM * sms
    part = torch.empty(blocks, dtype=torch.int64, device=plane.device)
    out = torch.empty((), dtype=torch.int64, device=plane.device)
    with torch.cuda.device(plane.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.lam_stream_i16(plane.data_ptr(), plane.numel() // 8,
                                  blocks, part.data_ptr(), out.data_ptr(),
                                  stream)
    stream_i16.launches += 1
    if code != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {code}")
    return out


stream_i16.launches = 0
stream_i16_plain.calls = 0
