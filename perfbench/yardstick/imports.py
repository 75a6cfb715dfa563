"""The check that the measured process loaded neither JAX nor the JAX
package. Module names are compared by their top-level name, whole: the
port's package, ``repro_torch``, begins with the JAX package's name."""
from __future__ import annotations

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_loaded(modules=None) -> list[str]:
    names = sys.modules if modules is None else modules
    tops = {name.split(".", 1)[0] for name in names}
    return sorted(tops.intersection(FORBIDDEN))


def refuse_forbidden() -> None:
    """Exit without a result, naming what was found, if this process has
    loaded any of `FORBIDDEN`."""
    found = forbidden_loaded()
    if found:
        sys.exit(f"the measured process loaded {found}: the benchmark runs the port alone")
