"""A job's spans on the ``torch.profiler`` timeline.

:class:`ProfilerSpans` is a PINS module: installed, it opens a
``torch.profiler`` user range named ``parsec.<span>`` at the BEGIN of each
of a job's spans (:data:`.pins.SPANS`: the front end's, the executor's,
the pump's, the device module's, the staging and compile spans) and closes
it at the END, with the payload's ``job``, ``id``, ``parent``, ``bytes``
and ``tiles`` as the range's keyword arguments (in the trace's ``args``
and the events' ``kwinputs`` under ``record_shapes=True``).  Under
``torch.profiler.profile(activities=[CPU, CUDA])`` the program's spans
and the card's kernels and copies are one trace on one clock:
``prof.export_chrome_trace(path)`` shows them together (Perfetto,
``chrome://tracing``), and ``prof.events()`` holds the ranges as CPU
events.

The profiler records the threads it profiles, the caller's by default:
the transfer lane's and the write-back committer's spans (stage depth 2
and above) need ``experimental_config=torch._C._profiler.
_ExperimentalConfig(profile_all_threads=True)``.  Install and uninstall
between jobs: a range open when the sink goes stays open.  Not
installed, the spans cost their sites' :func:`.pins.active` checks.
"""

from __future__ import annotations

import threading
from typing import Callable, List, Tuple

import torch

from . import pins

#: the payload keys a range carries as its arguments
ARGS = ("job", "id", "parent", "bytes", "tiles")


class ProfilerSpans:
    """``ProfilerSpans().install()`` puts every span of the program on the
    ``torch.profiler`` timeline as a ``parsec.<span>`` range until
    :meth:`uninstall`."""

    def __init__(self):
        self._subs: List[Tuple[str, Callable[..., None]]] = []
        #: ``stack``: this thread's open ranges, (span name, range)
        self._local = threading.local()

    def install(self) -> "ProfilerSpans":
        if self._subs:
            return self
        for name, (begin, end) in pins.SPANS.items():
            self._sub(begin, lambda es, info, name=name: self._begin(name, info))
            self._sub(end, lambda es, info, name=name: self._end(name))
        return self

    def uninstall(self) -> None:
        for site, cb in self._subs:
            pins.unsubscribe(site, cb)
        self._subs.clear()

    def _sub(self, site: str, cb: Callable[..., None]) -> None:
        pins.subscribe(site, cb)
        self._subs.append((site, cb))

    def _stack(self) -> list:
        return self._local.__dict__.setdefault("stack", [])

    def _begin(self, name: str, info) -> None:
        # torch's C++ range: an enter and exit cost ~1 us against ~13 us
        # for ``record_function``'s, and it keeps the arguments as values
        info = info or {}
        rf = torch._C._profiler._RecordFunctionFast(
            f"parsec.{name}", (), {k: info[k] for k in ARGS if k in info})
        rf.__enter__()
        self._stack().append((name, rf))

    def _end(self, name: str) -> None:
        # an END whose BEGIN came before the install opened nothing here
        stack = self._stack()
        if stack and stack[-1][0] == name:
            stack.pop()[1].__exit__(None, None, None)
