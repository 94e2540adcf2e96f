"""The benchmark's import rule: no module of JAX or of the JAX package may
be loaded by a run. Names are compared by their top-level part (before
the first dot) as a whole word, so the port `repro_torch` is not the JAX
package `repro`."""
from __future__ import annotations

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden(modules) -> list:
    """The loaded module names whose top-level name is forbidden."""
    return sorted(name for name in modules
                  if name.split(".", 1)[0] in FORBIDDEN)
