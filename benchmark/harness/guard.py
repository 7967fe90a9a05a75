"""What a run must not load: JAX, its libraries, or the JAX package the
port was made from. Names are compared by their top-level part whole,
since the port's own name begins with the JAX package's."""
from __future__ import annotations

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "garmentnets_tpu"})


def forbidden_loaded(modules=None) -> list:
    names = sys.modules if modules is None else modules
    return sorted({n.split(".", 1)[0] for n in names
                   if n.split(".", 1)[0] in FORBIDDEN})
