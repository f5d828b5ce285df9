"""Matmul precision for the float32 algebra of the engine.

On a GPU, XLA may run a float32 ``dot_general`` of default precision in
TF32, which keeps 10 mantissa bits: about 5 mm at 10 m range. Every
function that multiplies matrices here is wrapped in
``highest_precision``, so its dots are traced at ``Precision.HIGHEST``
(true float32) whatever program calls it, without a process-wide
setting.
"""

from __future__ import annotations

import functools

import jax


def highest_precision(fn):
    """Trace ``fn`` with float32 matmuls at ``Precision.HIGHEST``."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with jax.default_matmul_precision("highest"):
            return fn(*args, **kwargs)

    return wrapper
