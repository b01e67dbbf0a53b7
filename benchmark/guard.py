"""The check that no JAX and nothing of the JAX package was loaded.

Compared by top-level module name, whole: the part of each name in
`sys.modules` before the first dot against the list. A prefix test would
also catch the port, whose name begins with the JAX package's."""
from __future__ import annotations

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "pyqg_generative_tpu")


def forbidden_modules(names=None) -> list:
    """The forbidden top-level names among `names` (sys.modules'
    keys by default), sorted."""
    names = sys.modules if names is None else names
    return sorted({n.split(".", 1)[0] for n in names} & set(FORBIDDEN))
