"""MCA-style component (plugin) registry.

Mirrors the reference's Modular Component Architecture repository
(``parsec/mca/mca_repository.c``, ``mca.h``): components are
registered under a *framework type* (``sched``, ``termdet``, ``device``,
``comm``, ``pins``), each with a priority, and are discovered/opened by type.
Selection honours the ``mca`` parameter of the same name (reference:
``--mca sched lfq`` handled via ``mca_components_open_bytype`` in
``scheduling.c:216-242``): set ``PARSEC_MCA_mca_<framework>=<name>`` or
``mca_param.set_param("mca", "<framework>", "<name>")`` to force a component,
or a comma-separated include list.

Instead of dlopened ``.so`` components, registration is a class decorator;
in-tree components self-register at import time.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Dict, List, Optional, Type

from . import debug, mca_param


class Component:
    """Base class for all components. Subclasses set ``mca_name`` and
    ``mca_priority`` (higher wins) and may override ``available()`` to
    report whether they can run in this process (e.g. a device backend
    probing for hardware)."""

    mca_type: str = ""
    mca_name: str = ""
    mca_priority: int = 0

    @classmethod
    def available(cls) -> bool:
        return True


_registry: Dict[str, Dict[str, Type[Component]]] = {}
_lock = threading.Lock()


def register_component(framework: str) -> Callable[[Type[Component]], Type[Component]]:
    """Class decorator: ``@register_component("sched")``."""

    def deco(cls: Type[Component]) -> Type[Component]:
        if not cls.mca_name:
            raise ValueError(f"component {cls.__name__} missing mca_name")
        cls.mca_type = framework
        with _lock:
            _registry.setdefault(framework, {})[cls.mca_name] = cls
        return cls

    return deco


def components_of_type(framework: str) -> List[Type[Component]]:
    """All registered components of a framework, priority-sorted, filtered by
    the ``mca_<framework>`` selection parameter."""
    mca_param.register("mca", framework, "", help=f"comma list of {framework} components to allow (empty=all)")
    selection = str(mca_param.get("mca", framework) or "").strip()
    with _lock:
        comps = list(_registry.get(framework, {}).values())
    if selection:
        allowed = [s.strip() for s in selection.split(",") if s.strip()]
        comps = [c for c in comps if c.mca_name in allowed]
        # explicit selection order wins over priority
        comps.sort(key=lambda c: allowed.index(c.mca_name))
        return comps
    comps.sort(key=lambda c: -c.mca_priority)
    return comps


def open_component(framework: str, name: Optional[str] = None, *args: Any, **kw: Any) -> Component:
    """Instantiate the selected (or best available) component of a framework.

    Reference: ``mca_components_open_bytype`` + module selection loops.
    """
    comps = components_of_type(framework)
    if name:
        with _lock:
            cls = _registry.get(framework, {}).get(name)
        if cls is None:
            known = sorted(_registry.get(framework, {}))
            debug.fatal("no %s component named %r (known: %s)", framework, name, known)
        if not cls.available():
            debug.fatal("%s component %r is not available on this system", framework, name)
        return cls(*args, **kw)
    for cls in comps:
        if cls.available():
            debug.verbose(3, "mca", "selected %s component %r (priority %d)", framework, cls.mca_name, cls.mca_priority)
            return cls(*args, **kw)
    debug.fatal("no available %s component (registered: %s)", framework, [c.mca_name for c in comps])
    raise AssertionError  # unreachable; fatal raises


def component_names(framework: str) -> List[str]:
    with _lock:
        return sorted(_registry.get(framework, {}))
