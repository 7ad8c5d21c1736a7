"""Replay a PTG taskpool through the DTD engine.

The port of :mod:`parsec_tpu.dsl.ptg_to_dtd`.  Reference:
``parsec/mca/pins/ptg_to_dtd/`` — a harness that takes a PTG (compiled)
taskpool and re-executes it via DTD task insertion, checking that both DSL
front-ends drive the runtime identically.

Method: capture the static DAG (:mod:`parsec_tpu_torch.dsl.graph`), resolve every
flow to its ultimate memory tile (PTG threads data through producer chains;
DTD tracks dependencies per tile object, so handing each task its chain's
*source tile* reproduces exactly the declared ordering), then insert tasks
in topological program order.  CTL edges are reproduced with per-producer
dummy control tiles.

This is both a DSL-equivalence test harness and a stress of DTD's
last-writer/reader inference against independently-derived DAGs.  Only
CPU bodies replay, as in the reference: a class without one is refused.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from ..core.lifecycle import DEV_CPU
from ..data.data import Data, data_create
from .dtd import CTL as DTD_CTL, DTDTaskpool, IN, INOUT, OUT, VALUE
from .graph import capture, source_tile
from .ptg import CTL, PTGTaskpool, _expand_args


def replay_via_dtd(
    ptg_tp: PTGTaskpool,
    context,
    *,
    name: Optional[str] = None,
    wait: bool = True,
) -> DTDTaskpool:
    """Execute the PTG taskpool's whole DAG through DTD insertion.

    The PTG taskpool must be *unstarted* (never attached): this harness
    evaluates its declarations, it does not race its execution.
    """
    g = capture(ptg_tp, ranks=[context.rank])
    order = g.topo_order()
    dtd = DTDTaskpool(context, name=name or f"{ptg_tp.name}-as-dtd")
    consts = ptg_tp.constants

    tiles: Dict[Tuple, Data] = {}       # resolved source -> tile Data
    ctl_tiles: Dict[Tuple, Data] = {}   # producer tid -> dummy control tile

    def tile_for(srckey: Tuple) -> Data:
        if srckey[0] == "remote":
            # chain leaves the captured partition: a zeros stand-in would
            # silently corrupt numerics — this replay is single-partition
            raise RuntimeError(
                f"flow source {srckey[1]}/{srckey[2]} is on another rank; "
                "ptg_to_dtd replays one rank's full capture only")
        if srckey[0] == "data":
            _, cname, key = srckey
            return consts[cname].data_of(*key)
        d = tiles.get(srckey)
        if d is None:
            # ("new", producer tid, flow): per-flow NEW shape (dep
            # [type=...] props) resolved by the taskpool
            _, (pc_name, _locs), fname = srckey
            shape, dtype = ptg_tp.new_tile_spec(pc_name, fname)
            d = data_create(srckey, payload=np.zeros(shape, dtype))
            tiles[srckey] = d
        return d

    def ctl_tile(tid: Tuple) -> Data:
        d = ctl_tiles.get(tid)
        if d is None:
            d = data_create(("ctl", tid), payload=np.zeros(1))
            ctl_tiles[tid] = d
        return d

    for tid in order:
        cname, locs = tid
        pc = ptg_tp.ptg.classes[cname]
        node = g.nodes[tid]
        body = pc.bodies.get(DEV_CPU)
        if body is None:
            raise ValueError(f"ptg_to_dtd: class {cname} has no CPU body")

        args: List[Any] = []
        kw_order: List[str] = []
        for f in pc.flows:
            if f.mode == CTL:
                continue
            args.append((tile_for(source_tile(g, tid, f.name)), f.mode))
            kw_order.append(f.name)
        env = pc.env_of(locs, consts)
        for pname in pc.param_names + pc.def_names + pc.body_globals:
            args.append((env[pname], VALUE))
            kw_order.append(pname)
        # control edges: consume producers' dummy tiles, publish my own
        for f in pc.flows:
            if f.mode != CTL:
                continue
            for dep in f.deps_in:
                t = dep.target(env)
                if t is None or not hasattr(t, "class_name"):
                    continue
                for plocs in _expand_args(t.args, env):
                    src_pc = ptg_tp.ptg.classes[t.class_name]
                    if len(plocs) == len(src_pc.param_names) and src_pc.valid(plocs, consts):
                        args.append((ctl_tile((t.class_name, plocs)), DTD_CTL))
        # publish my control tile if anyone depends on me via CTL
        has_ctl_consumer = any(
            any(sf.name == sfname and sf.mode == CTL
                for sf in ptg_tp.ptg.classes[s[0]].flows)
            for (_fn, s, sfname) in node.out_edges
        )
        if has_ctl_consumer:
            args.append((ctl_tile(tid), DTD_CTL | OUT))

        def make_body(fn: Callable, names: List[str]):
            def dtd_body(*pos):
                return fn(**dict(zip(names, pos)))
            dtd_body.__name__ = getattr(fn, "__name__", "ptg_body")
            return dtd_body

        dtd.insert_task(make_body(body, kw_order), *args,
                        priority=node.priority, name=cname)

        # write-backs: PTG copies flow data to its home collection tile at
        # the producing task's completion — insert the copy task *now* so
        # DTD sequencing gives it the datum's value at this point of the
        # chain (later chain writers order after this reader). Aliased
        # write-backs (flow sourced from its own home tile) are free.
        for (fname, cname2, key) in node.write_backs:
            src = source_tile(g, tid, fname)
            home = ("data", cname2, tuple(key))
            if src != home:
                sdata = tile_for(src)
                hdata = tile_for(home)

                def copy_body(S, H):
                    np.copyto(H, np.asarray(S).reshape(H.shape))

                dtd.insert_task(copy_body, (sdata, IN), (hdata, INOUT),
                                name=f"writeback_{cname2}")

    if wait:
        dtd.flush_all()
        dtd.close()
    return dtd
