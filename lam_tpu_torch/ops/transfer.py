"""Host -> device uploads through pinned staging memory (lam_tpu/ops/transfer.py).

The JAX package folds 64 MB chunks into a donated device buffer because
its link to the TPU handled one-shot multi-GB transfers badly. Here the
same three entry points stream through a ring of pinned (page-locked)
staging slots into ONE device tensor allocated up front:

  * `to_device(buf, device)`: a host array as a device tensor;
  * `Folder(shape, dtype, device)`: a plane that a worker thread is still
    filling on the host, uploaded as its rows become final
    (`advance(host, avail)`, then `result()`): the cold fq pack's
    pipeline, packing and uploading at once (solver/operators.py);
  * `stream_file_to_device(path, offset, dtype, shape, device)`: a plane
    of a file, a reader thread reading the next chunk into a free slot
    while the main thread's copy of the last one runs
    (solver/pack_cache.py's warm loads).

A slot is filled by COPY_THREADS host threads at once (numpy copies and
`os.preadv` release the GIL; one thread reads the page cache or copies
memory at a fraction of the host's rate), and its copy to the card is
`copy_(..., non_blocking=True)` on the current stream, so the card's copy
engine moves it while the host fills the next slot.
A slot is refilled only after the CUDA event recorded behind its last
copy has completed (`_Ring.acquire`): refilled earlier, it would change
bytes still in flight. The destination is written row by row in place,
so the device holds the one tensor and nothing else. On the CPU the same
code copies through plain (unpinned) slots, synchronously: the tests
hold the chunking there. Buffers below MIN_STAGED bytes are uploaded in
one plain copy.
"""

from __future__ import annotations

import functools
import os
import queue
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

CHUNK_BYTES = 64 << 20   # one staging slot
RING_DEPTH = 3           # slots: one filling, one copying, one spare
COPY_THREADS = 4         # host threads filling one slot
MIN_STAGED = 4 << 20     # smaller buffers: one plain copy


@functools.lru_cache(maxsize=None)
def _pool():
    return ThreadPoolExecutor(COPY_THREADS, thread_name_prefix="lam-stage")


def _spans(n):
    """[0, n) cut into COPY_THREADS spans."""
    k = COPY_THREADS
    return [(i * n // k, (i + 1) * n // k) for i in range(k)]


def _fill(dst, src):
    """np.copyto(dst, src) by COPY_THREADS threads, split by rows."""
    if dst.shape[0] < COPY_THREADS or dst.nbytes < (4 << 20):
        np.copyto(dst, src)
        return
    list(_pool().map(lambda ab: np.copyto(dst[ab[0]:ab[1]], src[ab[0]:ab[1]]),
                     _spans(dst.shape[0])))


def _read_into(fd, view, offset, path):
    """Fill the uint8 array `view` from byte `offset` of the open file fd
    by COPY_THREADS threads; IOError on a short read."""
    def span(ab):
        got, end = ab
        while got < end:
            k = os.preadv(fd, [memoryview(view[got:end])], offset + got)
            if k <= 0:
                raise IOError(f"{path}: short read at offset {offset + got}")
            got += k
    list(_pool().map(span, _spans(view.size)))


def _device(device):
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _rows_per_chunk(shape, itemsize, chunk_bytes):
    row_bytes = max(1, int(np.prod(shape[1:], dtype=np.int64)) * itemsize)
    return max(1, chunk_bytes // row_bytes)


class _Ring:
    """RING_DEPTH staging slots of chunk_bytes, pinned on a CUDA device,
    handed out in turn; a slot comes back only after its copy has been
    issued (`send`), and is refilled only after that copy has finished."""

    def __init__(self, device, chunk_bytes, depth=RING_DEPTH):
        self.device = device
        self.cuda = device.type == "cuda"
        self.slots = [torch.empty(chunk_bytes, dtype=torch.uint8,
                                  pin_memory=self.cuda)
                      for _ in range(depth)]
        self.events = [None] * depth
        self.free: queue.Queue = queue.Queue()
        for i in range(depth):
            self.free.put(i)

    def acquire(self):
        """A free slot's index, once its last copy has completed."""
        i = self.free.get()
        if self.events[i] is not None:
            self.events[i].synchronize()
        return i

    def host_view(self, i, dtype, shape):
        """Slot i as a numpy array of `shape` to fill on the host."""
        count = int(np.prod(shape, dtype=np.int64))
        nbytes = count * np.dtype(dtype).itemsize
        return self.slots[i][:nbytes].numpy().view(dtype).reshape(shape)

    def send(self, i, dst):
        """Copy slot i's first dst.nbytes bytes into the device rows
        `dst`, then give the slot back."""
        nbytes = dst.numel() * dst.element_size()
        src = self.slots[i][:nbytes].view(dst.dtype).view(dst.shape)
        dst.copy_(src, non_blocking=self.cuda)
        if self.cuda:
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(self.device))
            self.events[i] = ev
        self.free.put(i)

    def drain(self):
        """Wait for every copy issued through the ring."""
        for ev in self.events:
            if ev is not None:
                ev.synchronize()


_TORCH_OF = {np.dtype(np.float32): torch.float32,
             np.dtype(np.float64): torch.float64,
             np.dtype(np.int16): torch.int16}


def _empty(shape, dtype, dev):
    return torch.empty(tuple(int(s) for s in shape),
                       dtype=_TORCH_OF[np.dtype(dtype)], device=dev)


def to_device(buf, device, chunk_bytes=None):
    """A host array as a new tensor on `device` (a tensor is moved there,
    kept as it is when it is there already). Arrays of MIN_STAGED bytes
    or more (of one chunk_bytes, where given) go through the pinned ring;
    the result is the host bytes."""
    dev = _device(device)
    if isinstance(buf, torch.Tensor):
        return buf.to(dev)
    arr = np.asarray(buf)
    cb = chunk_bytes or CHUNK_BYTES
    if (arr.ndim == 0 or arr.nbytes < (chunk_bytes or MIN_STAGED)
            or np.dtype(arr.dtype) not in _TORCH_OF):
        return torch.tensor(arr, device=dev)
    out = _empty(arr.shape, arr.dtype, dev)
    rpc = min(arr.shape[0], _rows_per_chunk(arr.shape, arr.itemsize, cb))
    ring = _Ring(dev, rpc * (arr.nbytes // arr.shape[0]))
    for r0 in range(0, arr.shape[0], rpc):
        rows = arr[r0:r0 + rpc]
        i = ring.acquire()
        _fill(ring.host_view(i, arr.dtype, rows.shape), rows)
        ring.send(i, out[r0:r0 + rows.shape[0]])
    ring.drain()
    return out


class Folder:
    """Upload of a (rows, ...) plane whose host buffer a worker fills in
    row order: `advance(host, avail)` copies every whole chunk of the
    first `avail` rows not copied yet (and, once avail reaches the row
    count, the rest); `result()` is the device tensor once all rows
    went."""

    def __init__(self, shape, dtype, device, chunk_bytes=None):
        self.shape = tuple(int(s) for s in shape)
        self.dtype = np.dtype(dtype)
        self.m = self.shape[0]
        dev = _device(device)
        cb = chunk_bytes or CHUNK_BYTES
        self.rpc = min(self.m, _rows_per_chunk(self.shape,
                                               self.dtype.itemsize, cb))
        row_bytes = self.dtype.itemsize * int(np.prod(self.shape[1:],
                                                      dtype=np.int64))
        self.out = _empty(self.shape, self.dtype, dev)
        self.ring = _Ring(dev, self.rpc * row_bytes)
        self.done = 0

    def _send(self, host, r0, r1):
        i = self.ring.acquire()
        _fill(self.ring.host_view(i, self.dtype, (r1 - r0,) + self.shape[1:]),
              host[r0:r1])
        self.ring.send(i, self.out[r0:r1])

    def advance(self, host, avail):
        while self.done + self.rpc <= avail:
            self._send(host, self.done, self.done + self.rpc)
            self.done += self.rpc
        if avail >= self.m and self.done < self.m:
            self._send(host, self.done, self.m)
            self.done = self.m

    def result(self):
        if self.done < self.m:
            raise RuntimeError("Folder not finished (advance to the row "
                               "count)")
        self.ring.drain()
        return self.out


def stream_file_to_device(path, offset, dtype, shape, device,
                          chunk_bytes=None):
    """The contiguous (rows, ...) plane at byte `offset` of `path` as a
    device tensor, a reader thread reading each chunk into a staging slot
    while the main thread copies the previous one to the device. Raises
    IOError on a short read: the caller treats the file as unusable,
    never as truncated data."""
    dev = _device(device)
    dtype = np.dtype(dtype)
    shape = tuple(int(s) for s in shape)
    m = shape[0]
    row_elems = int(np.prod(shape[1:], dtype=np.int64))
    row_bytes = row_elems * dtype.itemsize
    cb = chunk_bytes or CHUNK_BYTES
    rpc = min(m, _rows_per_chunk(shape, dtype.itemsize, cb))
    if m * row_bytes < (chunk_bytes or MIN_STAGED):
        with open(path, "rb") as fh:
            fh.seek(offset)
            buf = np.fromfile(fh, dtype=dtype, count=m * row_elems)
        if buf.size != m * row_elems:
            raise IOError(f"{path}: short read at offset {offset}")
        return torch.from_numpy(buf.reshape(shape)).to(dev)

    out = _empty(shape, dtype, dev)
    ring = _Ring(dev, rpc * row_bytes)
    full: queue.Queue = queue.Queue()
    stop = threading.Event()

    def reader():
        try:
            fd = os.open(path, os.O_RDONLY)
            try:
                for r0 in range(0, m, rpc):
                    if stop.is_set():
                        return
                    rows = min(rpc, m - r0)
                    i = ring.acquire()
                    _read_into(fd, ring.host_view(i, np.uint8,
                                                  (rows * row_bytes,)),
                               offset + r0 * row_bytes, path)
                    full.put((i, r0, rows))
            finally:
                os.close(fd)
            full.put(None)
        except BaseException as e:  # re-raised by the main thread
            full.put(e)

    t = threading.Thread(target=reader, daemon=True)
    t.start()
    try:
        while True:
            item = full.get()
            if item is None:
                break
            if isinstance(item, BaseException):
                raise item
            i, r0, rows = item
            ring.send(i, out[r0:r0 + rows])
    finally:
        stop.set()
        # unblock a reader waiting for a slot, then let it end
        for k in range(RING_DEPTH):
            ring.free.put(k)
        t.join()
    ring.drain()
    return out
