"""L0 utilities: parameter registry, debug streams, component registry.

The port's own copy of :mod:`parsec_tpu.utils` (the JAX package is never
imported from here): MCA parameters, leveled debug output and the
component registry are framework-neutral and carried over unchanged.
"""

from . import debug, mca_param
from .components import Component, component_names, components_of_type, open_component, register_component
from .mca_param import params

__all__ = [
    "debug",
    "mca_param",
    "params",
    "Component",
    "register_component",
    "open_component",
    "components_of_type",
    "component_names",
]
