"""The check that a run loaded no JAX: the program under test is the
PyTorch port, and nothing of the JAX package or of JAX may run beside it.
Names are compared by their whole top-level part (before the first dot):
`orb_slam2_tpu_torch` begins with `orb_slam2_tpu` and is not it."""
from __future__ import annotations

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "orb_slam2_tpu")


def forbidden_modules(modules=None) -> list:
    """The loaded modules whose top-level name is forbidden, sorted."""
    names = sys.modules if modules is None else modules
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)
