"""Frame prefetching on a producer thread into a bounded buffer, optionally
onto a device (counterpart of ``bpvo_tpu/data/loader.py``; reference
``utils/dataset_loader_thread.{h,cc}`` and ``utils/bounded_buffer.h``).

The producer reads frames in order and puts them in a queue; ``None`` marks
the end of the sequence (dataset_loader_thread.cc:43-47).  With a CUDA
``device`` (the JAX package's ``device_prefetch``) the producer also runs
on a CUDA stream of its own, so a stereo matcher inside ``get_frame``
issues its kernels there: it copies each frame into a ring of pinned host
buffers, issues the host-to-device copies without blocking and records an
event after them.  ``pop`` makes the consumer's current stream wait for
that event and marks the tensors as used on that stream, so the caching
allocator cannot hand their memory back to the producer's stream before
the consumer's work on them is done; a pinned slot is refilled only after
the event of the copies that read it has completed.

A failure inside ``get_frame`` ends the sequence and is raised again by the
consumer's next ``pop`` after the frames before it: nothing is dropped in
silence.  ``pop`` returns None at the end of the sequence and after its
timeout; iterating waits for as long as the producer is alive.
"""
from __future__ import annotations

import queue
import threading
from typing import Optional

import numpy as np
import torch

from bpvo_tpu_torch.data.dataset import Dataset, DatasetFrame
from bpvo_tpu_torch.vo.device_vo import resolve_device

_END = None
_PINNED_SLOTS = 2      # a slot is refilled after its copies completed


class _PinnedRing:
    """Pinned host buffers for the (image, disparity) of a frame, each slot
    with the event recorded after the copies that read it."""

    def __init__(self):
        self._bufs = [None] * _PINNED_SLOTS
        self._events = [None] * _PINNED_SLOTS
        self._next = 0

    def fill(self, arrays, device, stream):
        """Copy ``arrays`` through the next slot into new tensors on
        ``device``, issued on ``stream``; returns (tensors, the event
        recorded after the copies)."""
        k = self._next
        self._next = (k + 1) % _PINNED_SLOTS
        if self._events[k] is not None:
            self._events[k].synchronize()      # its last copies are done
        shapes = [a.shape for a in arrays]
        if self._bufs[k] is None or [b.shape for b in self._bufs[k]] != [
                torch.Size(s) for s in shapes]:
            self._bufs[k] = [torch.empty(s, dtype=torch.float32,
                                         pin_memory=True) for s in shapes]
        out = []
        for a, buf in zip(arrays, self._bufs[k]):
            buf.numpy()[...] = a
            t = torch.empty(a.shape, dtype=torch.float32, device=device)
            t.copy_(buf, non_blocking=True)
            out.append(t)
        event = self._events[k] = torch.cuda.Event()
        event.record(stream)
        return out, event


class DatasetLoaderThread:
    """Iterate the frames of ``dataset`` with readahead.

    ``device``: None keeps the frames as the dataset returns them (numpy);
    ``"cpu"`` turns image and disparity into float32 CPU tensors; a CUDA
    device prefetches them there (see the module docstring).  A CUDA device
    that is not available raises.

    Usage:
        with DatasetLoaderThread(dataset, buffer_size=16) as loader:
            for frame in loader: ...
    """

    def __init__(self, dataset: Dataset, buffer_size: int = 16,
                 start_frame: int = 0, max_frames: Optional[int] = None,
                 device=None):
        self._dataset = dataset
        self._buffer: "queue.Queue" = queue.Queue(maxsize=buffer_size)
        self._stop = threading.Event()
        self._start_frame = start_frame
        self._max_frames = max_frames
        self._device = None if device is None else resolve_device(device)
        self._cuda = self._device is not None and self._device.type == "cuda"
        self._stream = torch.cuda.Stream(self._device) if self._cuda else None
        self._ring = _PinnedRing() if self._cuda else None
        self._error: Optional[Exception] = None
        self._thread = threading.Thread(target=self._producer, daemon=True)
        self._thread.start()

    def _producer(self):
        i = self._start_frame
        n = 0
        try:
            while not self._stop.is_set():
                if self._max_frames is not None and n >= self._max_frames:
                    break
                if self._cuda:
                    with torch.cuda.stream(self._stream):
                        frame = self._dataset.get_frame(i)
                        item = self._to_device(frame)
                else:
                    frame = self._dataset.get_frame(i)
                    item = (frame, None)
                if frame is None:
                    break
                if self._device is not None and not self._cuda:
                    for name in ("image", "disparity"):
                        setattr(frame, name, torch.as_tensor(
                            np.asarray(getattr(frame, name), np.float32)))
                self._put(item)
                i += 1
                n += 1
        except Exception as e:                      # re-raised by pop()
            self._error = e
        self._put((_END, None))

    def _to_device(self, frame):
        """(frame with CUDA tensors, the event after their copies), issued
        on the producer's stream."""
        if frame is None:
            return None, None
        (frame.image, frame.disparity), event = self._ring.fill(
            [np.asarray(frame.image, np.float32),
             np.asarray(frame.disparity, np.float32)],
            self._device, self._stream)
        return frame, event

    def _put(self, item):
        while not self._stop.is_set():
            try:
                self._buffer.put(item, timeout=0.1)
                return
            except queue.Full:
                continue

    def _take(self, frame, event) -> Optional[DatasetFrame]:
        if frame is _END:
            self._buffer.put((_END, None))     # later pops see the end too
            if self._error is not None:
                raise self._error
            return None
        if event is not None:
            stream = torch.cuda.current_stream(self._device)
            stream.wait_event(event)
            frame.image.record_stream(stream)
            frame.disparity.record_stream(stream)
        return frame

    def pop(self, timeout: float = 5.0) -> Optional[DatasetFrame]:
        """Blocking pop with timeout; None at the end of the sequence (or
        when nothing came within ``timeout``)."""
        try:
            return self._take(*self._buffer.get(timeout=timeout))
        except queue.Empty:
            return None

    def stop(self, timeout: float = 30.0):
        """Ask the producer to stop and wait for it (up to ``timeout``)."""
        self._stop.set()
        self._thread.join(timeout)

    def is_running(self) -> bool:
        return self._thread.is_alive()

    def __iter__(self):
        while True:
            try:
                item = self._buffer.get(timeout=0.5)
            except queue.Empty:
                if self._thread.is_alive():
                    continue
                return
            frame = self._take(*item)
            if frame is None:
                return
            yield frame

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()
