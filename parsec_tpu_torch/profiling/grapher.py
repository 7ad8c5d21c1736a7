"""DOT capture of the executed DAG.

Reference: ``parsec/parsec_prof_grapher.c`` — one DOT file
per rank of the tasks that actually executed and the dependency edges that
released them (enabled with ``--mca profile_dot``). Here a PINS subscriber
records nodes at completion and edges from the release payload.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Tuple

from . import pins

_CLASS_COLORS = [
    "#66c2a5", "#fc8d62", "#8da0cb", "#e78ac3", "#a6d854", "#ffd92f",
    "#e5c494", "#b3b3b3",
]


class DotGrapher:
    def __init__(self, rank: int = 0):
        self.rank = rank
        self._nodes: List[Tuple[str, str]] = []  # (id, label)
        self._edges: List[Tuple[str, str]] = []
        self._classes: Dict[str, int] = {}
        self._lock = threading.Lock()
        self._cb = None

    @staticmethod
    def _nid(task) -> str:
        loc = "_".join(str(x) for x in task.locals)
        return f"{task.task_class.name}_{loc}" if loc else task.task_class.name

    def install(self) -> "DotGrapher":
        def on_release(es, payload):
            task, ready = payload
            with self._lock:
                self._classes.setdefault(task.task_class.name, len(self._classes))
                self._nodes.append((self._nid(task), repr(task)))
                for succ in ready or ():
                    self._edges.append((self._nid(task), self._nid(succ)))

        self._cb = on_release
        pins.subscribe(pins.RELEASE_DEPS_END, on_release)
        return self

    def uninstall(self) -> None:
        if self._cb is not None:
            pins.unsubscribe(pins.RELEASE_DEPS_END, self._cb)
            self._cb = None

    def dump(self, path: str) -> int:
        with self._lock, open(path, "w") as f:
            f.write(f"digraph rank{self.rank} {{\n")
            for nid, label in self._nodes:
                cls = nid.rsplit("_", 1)[0] if "_" in nid else nid
                ci = self._classes.get(cls.split("_")[0], 0)
                color = _CLASS_COLORS[ci % len(_CLASS_COLORS)]
                f.write(f'  "{nid}" [label="{label}", style=filled, fillcolor="{color}"];\n')
            for a, b in self._edges:
                f.write(f'  "{a}" -> "{b}";\n')
            f.write("}\n")
        return len(self._nodes)

    @property
    def n_nodes(self) -> int:
        return len(self._nodes)

    @property
    def n_edges(self) -> int:
        return len(self._edges)
