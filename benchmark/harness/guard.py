"""The check that the measured process never loaded the JAX package or
JAX itself: modules are compared by their whole top-level name (the part
before the first dot), since the port's name begins with the JAX
package's."""

from __future__ import annotations

import sys
from typing import List

FORBIDDEN = ("jax", "jaxlib", "flax", "qkd_ldpc_v_tpu")


def forbidden_modules(modules=None) -> List[str]:
    names = sys.modules if modules is None else modules
    return sorted({name.split(".", 1)[0] for name in names}
                  & set(FORBIDDEN))
