"""The JAX package's reference computations in the port's tests, each as
one compiled program.

Called eagerly, the JAX package's ops and layers run primitive by
primitive: each primitive, and each Pallas kernel in interpret mode, is
compiled on its own, which costs a test far more than its arithmetic.
``jit_vjp`` traces a function and its VJP once and compiles them together:
the same function on the same inputs.
"""

import jax


def jit_vjp(fn, primals, cotangent):
    """(``fn(*primals)``, the VJP of ``fn`` at ``primals`` applied to
    ``cotangent`` cast to the output's dtype), from one jitted program."""

    def both(primals, cotangent):
        out, vjp = jax.vjp(fn, *primals)
        return out, vjp(cotangent.astype(out.dtype))

    return jax.jit(both)(tuple(primals), cotangent)
