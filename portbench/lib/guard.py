"""The JAX side must not load in a benchmark process.

Names are compared whole, by the part of a module's name before the first
dot: the port's package, ``stdd_torch``, begins with the letters of the JAX
package's name, ``stdd_tpu``, and must not match it.
"""

from __future__ import annotations

import sys
from typing import Iterable, List

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "optax", "stdd_tpu"})


def top_level(name: str) -> str:
    return name.split(".", 1)[0]


def forbidden_in(names: Iterable[str]) -> List[str]:
    """The forbidden top-level names among ``names``, sorted."""
    return sorted({top_level(n) for n in names} & FORBIDDEN)


def loaded_forbidden() -> List[str]:
    """The forbidden packages this process has imported."""
    return forbidden_in(list(sys.modules))
