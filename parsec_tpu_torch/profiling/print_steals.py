"""print_steals — per-worker scheduling statistics report.

Reference: ``parsec/mca/pins/print_steals/`` counts where
each worker's selected tasks came from (own queue vs stolen) and prints a
per-thread summary at teardown.  Here: snapshot the execution streams'
``executed`` / ``selected`` / ``steals`` counters (the work-stealing
schedulers account steals at their victim-pop sites) and report on
demand or automatically at context teardown."""

from __future__ import annotations

from typing import List


class PrintSteals:
    """``PrintSteals(context)`` arms the module; the report prints when
    the context finalizes (or call :meth:`report` anytime)."""

    def __init__(self, context, auto: bool = True):
        self.context = context
        if auto:
            context.on_fini(self._print)

    def snapshot(self) -> List[dict]:
        rows = []
        for es in self.context.streams:
            st = es.stats
            rows.append({
                "worker": es.worker_id,
                "executed": st.get("executed", 0),
                "selected": st.get("selected", 0),
                "steals": st.get("steals", 0),
            })
        return rows

    def report(self) -> str:
        rows = self.snapshot()
        total = sum(r["executed"] for r in rows) or 1
        lines = [f"{'worker':>6} {'executed':>9} {'selected':>9} "
                 f"{'steals':>7} {'share':>6}"]
        for r in rows:
            lines.append(
                f"{r['worker']:>6} {r['executed']:>9} {r['selected']:>9} "
                f"{r['steals']:>7} {r['executed'] / total:>6.1%}")
        stolen = sum(r["steals"] for r in rows)
        lines.append(f"total steals: {stolen} "
                     f"({stolen / total:.1%} of executed tasks)")
        return "\n".join(lines)

    def _print(self) -> None:
        from ..utils import debug

        for line in self.report().split("\n"):
            debug.verbose(1, "steals", "%s", line)
