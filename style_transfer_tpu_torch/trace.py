"""Spans and launch counts of the stylize loop, on the profiler's clock.

A span (:func:`span`) marks one layer boundary of ``StyleTransfer.stylize``:
the whole call (``stylize``), a scale, its target capture, the resize of the
optimized image, the dispatch of a chunk, the processing of a queued chunk
(its loss fetch and its callback hand-off) and the output. A counter
(``ops.kernels._build.LaunchCount.add``) counts each launch of a kernel
wrapper by kernel and shape. The names of both are listed in ``PERF.md``
beside the metric each feeds.

Recording is on while a ``torch.profiler`` session is active, or inside a
:func:`recording` block. Off, a span or a count costs one flag check (and a
span one more check for listeners). On, a span is ``(name, t0_ns, t1_ns,
span_id, parent_id, call_id, thread_id, attrs)`` with both ends from
``time.time_ns()``, the clock of the profiler's kineto events
(``start_ns()``), and is also entered as a
``torch.profiler.record_function("style_transfer.<name>")`` range inside
those ends, so that a profiler trace (the CLI's ``--profile-dir``) carries
it. A span's parent is the innermost recorded span open on its thread; every
span of one ``stylize`` call (:func:`call`) has that call's id. Whether a
span records is decided where it opens: one opened before the profiler
started is not recorded, even where its children are.

Spans and counts stay in memory until :func:`clear`; reading them
(:func:`spans`, :func:`counts`) does not clear them, so several readers can
read one run. A listener (:func:`listen`) is called at each span's start and
end whether or not recording is on: the public hook at each chunk's
dispatch.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
from typing import Callable, Dict, Iterator, List, NamedTuple, Optional, Tuple

import torch
from torch.autograd import profiler as _profiler

#: Prefix of the ``record_function`` ranges the spans enter.
PREFIX = "style_transfer."

Listener = Callable[[str, str, dict], None]


class Span(NamedTuple):
    """One recorded span; ``t0_ns``/``t1_ns`` from ``time.time_ns()``,
    ``parent_id`` None where no recorded span was open on the thread."""

    name: str
    t0_ns: int
    t1_ns: int
    span_id: int
    parent_id: Optional[int]
    call_id: Optional[int]
    thread_id: int
    attrs: dict


_lock = threading.Lock()
_spans: List[Span] = []
_counts: Dict[Tuple[str, str, tuple], int] = {}
_listeners: List[Listener] = []
_forced = 0  # open recording() blocks
_ids = itertools.count(1)
_calls = itertools.count(1)
_local = threading.local()  # .stack: ids of this thread's open recorded spans; .call


def active() -> bool:
    """Whether spans and counts record now."""
    return _forced > 0 or _profiler._is_profiler_enabled


@contextlib.contextmanager
def recording() -> Iterator[None]:
    """Records spans and counts inside the block, with or without a profiler."""
    global _forced
    with _lock:
        _forced += 1
    try:
        yield
    finally:
        with _lock:
            _forced -= 1


class _Span:
    __slots__ = ("name", "attrs", "span_id", "parent_id", "t0", "range")

    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs, self.span_id = name, attrs, None

    def __enter__(self):
        for fn in tuple(_listeners):  # a listener may start the profiler: before the check
            fn("start", self.name, self.attrs)
        if not active():
            return self
        stack = _stack()
        self.parent_id = stack[-1] if stack else None
        self.span_id = next(_ids)
        stack.append(self.span_id)
        self.t0 = time.time_ns()
        self.range = torch.profiler.record_function(PREFIX + self.name)
        self.range.__enter__()
        return self

    def __exit__(self, *exc):
        if self.span_id is not None:
            self.range.__exit__(*exc)
            t1 = time.time_ns()
            _stack().pop()
            record = Span(self.name, self.t0, t1, self.span_id, self.parent_id,
                          getattr(_local, "call", None), threading.get_ident(), self.attrs)
            with _lock:
                _spans.append(record)
        for fn in tuple(_listeners):
            fn("end", self.name, self.attrs)
        return False


def _stack() -> List[int]:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


_OFF = contextlib.nullcontext()


def span(name: str, **attrs):
    """A context manager that records the span ``name`` with ``attrs``
    (host values) where recording is on, and calls the listeners."""
    if not (_listeners or active()):
        return _OFF
    return _Span(name, attrs)


@contextlib.contextmanager
def call(**attrs) -> Iterator[None]:
    """The ``stylize`` span of one call: the spans opened inside it on this
    thread take its call id, recorded or not."""
    outer = getattr(_local, "call", None)
    _local.call = next(_calls)
    try:
        with span("stylize", **attrs):
            yield
    finally:
        _local.call = outer


def count(wrapper: str, kernel: str, shape: tuple) -> None:
    """Adds one launch of ``kernel`` by ``wrapper`` at ``shape`` (called by
    ``LaunchCount.add`` while recording)."""
    key = (wrapper, kernel, shape)
    with _lock:
        _counts[key] = _counts.get(key, 0) + 1


def spans() -> List[Span]:
    """The recorded spans, in the order they closed."""
    with _lock:
        return list(_spans)


def counts() -> Dict[Tuple[str, str, tuple], int]:
    """Launches recorded, by ``(wrapper, kernel, shape)``."""
    with _lock:
        return dict(_counts)


def clear() -> None:
    """Empties the recorded spans and counts."""
    with _lock:
        _spans.clear()
        _counts.clear()


class Handle:
    """What :func:`listen` returns; :meth:`remove` stops the calls."""

    def __init__(self, fn: Listener):
        self.fn = fn

    def remove(self) -> None:
        with _lock:
            if self.fn in _listeners:
                _listeners.remove(self.fn)


def listen(fn: Listener) -> Handle:
    """Calls ``fn(phase, name, attrs)``, ``phase`` ``"start"`` or ``"end"``,
    synchronously at each span's start and end on the span's thread, whether
    or not recording is on: ``dispatch`` starts and ends once per chunk,
    before the chunk's first launch and after its last."""
    with _lock:
        _listeners.append(fn)
    return Handle(fn)
