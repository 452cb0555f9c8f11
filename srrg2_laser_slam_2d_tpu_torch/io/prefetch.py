"""Asynchronous host-to-device scan streaming (counterpart of
``srrg2_laser_slam_2d_tpu/io/prefetch.py``): a background thread stages the
next items on the device while the current frame computes.

On a CUDA device the thread copies each item from pinned memory on a side
stream (``non_blocking``) and records an event there; the consumer's
current stream waits on that event before it receives the item, and every
copied tensor is marked as used by the consumer's stream
(``record_stream``), so the caching allocator does not hand its memory out
again while the consumer may still read it. On the CPU nothing is staged:
the items come through in order.
"""

from __future__ import annotations

import queue
import threading

import numpy as np
import torch

from .._device import resolve_device


def _map(fn, item):
    """``fn`` over the tensor and array leaves of a nested structure (dicts,
    lists, tuples, NamedTuples); other leaves pass through."""
    if isinstance(item, (torch.Tensor, np.ndarray)):
        return fn(item)
    if isinstance(item, dict):
        return {k: _map(fn, v) for k, v in item.items()}
    if isinstance(item, tuple) and hasattr(item, "_fields"):
        return type(item)(*(_map(fn, v) for v in item))
    if isinstance(item, (list, tuple)):
        return type(item)(_map(fn, v) for v in item)
    return item


def _leaves(item) -> list:
    out = []

    def keep(x):
        out.append(x)
        return x

    _map(keep, item)
    return out


class DevicePrefetcher:
    """Wrap an iterable of nested structures of tensors and arrays; yields
    them as tensors on ``device`` (the CUDA card by default) ``depth`` items
    ahead of consumption. An exception of the source is raised on the
    consumer's side."""

    _DONE = object()

    def __init__(self, iterable, depth: int = 2, device=None):
        self._device = resolve_device(device)
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._err = None
        cuda = self._device.type == "cuda"
        self._stream = torch.cuda.Stream(self._device) if cuda else None

        def stage(x):
            t = torch.from_numpy(np.ascontiguousarray(x)) if isinstance(x, np.ndarray) else x
            if t.device.type == "cpu" and not t.is_pinned():
                t = t.pin_memory()
            return t.to(self._device, non_blocking=True)

        def worker():
            try:
                for item in iterable:
                    if not cuda:
                        self._q.put((_map(torch.as_tensor, item), None))
                        continue
                    with torch.cuda.stream(self._stream):
                        staged = _map(stage, item)
                        ready = torch.cuda.Event()
                        ready.record(self._stream)
                    self._q.put((staged, ready))
            except BaseException as e:  # surfaced on the consumer side
                self._err = e
            finally:
                self._q.put(self._DONE)

        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()

    def __iter__(self):
        return self

    def __next__(self):
        got = self._q.get()
        if got is self._DONE:
            if self._err is not None:
                raise self._err
            raise StopIteration
        item, ready = got
        if ready is not None:
            consumer = torch.cuda.current_stream(self._device)
            consumer.wait_event(ready)
            for t in _leaves(item):
                t.record_stream(consumer)
        return item
