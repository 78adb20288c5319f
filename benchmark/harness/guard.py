"""The check that nothing a run loaded is JAX or the JAX package.

Names are compared by their top-level part (before the first dot), whole:
``morfem_tpu_torch.ops`` passes, ``morfem_tpu.ops``, ``jax.numpy`` and
``jaxlib`` do not.
"""

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "morfem_tpu")


def forbidden_modules(names=None):
    """Sorted top-level names among `names` (default: ``sys.modules``)
    that are forbidden."""
    names = sys.modules if names is None else names
    return sorted({n.split(".")[0] for n in names
                   if n.split(".")[0] in FORBIDDEN})
