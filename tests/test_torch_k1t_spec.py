"""K1T's specification held against the JAX package, on CPU tensors.

The JAX package has no backward kernel for its fused tree levels: it
differentiates two applications of its plain level
(``fnft_tpu/ops/poly.py`` ``_tree_level_2x2``, normalize off). The port's
``fused_tree_levels_vjp`` (on a CPU tensor its plain route, the reference
that the CUDA kernel K1T is held to on the card) must give what
``jax.vjp`` of those two levels gives on the same seeded inputs. The two
conventions differ by a conjugation: for a holomorphic map JAX's VJP is
the cotangent against the Jacobian, torch's against its conjugate, so
torch's gradient at g is conj(jax_vjp(conj(g))). With the forward's
exponents w the port's output is the product times 2^-w, w a constant of
the derivative, so its VJP at g is JAX's at g 2^-w. Tolerance 1e-12
relative to the largest component (one rounding order apart).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fnft_tpu.ops.poly import _tree_level_2x2
from fnft_tpu_torch.ops import kernels

torch.set_num_threads(1)


def _two_levels(p):
    x, _ = _tree_level_2x2(p, None, False)
    x, _ = _tree_level_2x2(x, None, False)
    return x


@jax.jit
def _jax_vjp(p, ct):
    return jax.vjp(_two_levels, p)[1](ct)[0]


@pytest.mark.parametrize("normalize", [False, True])
@pytest.mark.parametrize("c", [2, 3, 4])
def test_vjp_matches_jax_vjp_of_two_plain_levels(c, normalize):
    rng = np.random.default_rng(40 + c)
    shape = (2, 256, 2, 2, c)
    p = rng.normal(size=shape) + 1j * rng.normal(size=shape)
    out_shape = (2, 64, 2, 2, 4 * c - 3)
    g = rng.normal(size=out_shape) + 1j * rng.normal(size=out_shape)
    p_t = torch.as_tensor(p)
    w = None
    scale = np.ones(out_shape[:2])
    if normalize:
        _, w = kernels.fused_tree_levels_plain(p_t, 2, normalize=True)
        assert int(w.abs().min()) > 0
        scale = 2.0 ** -w.numpy().astype(np.float64)
    ref = np.conj(np.asarray(_jax_vjp(
        jnp.asarray(p), jnp.asarray(np.conj(g) * scale[..., None, None, None]))))
    got = kernels.fused_tree_levels_vjp(p_t, w, torch.as_tensor(g), 2).numpy()
    rel = np.abs(got - ref).max() / np.abs(ref).max()
    assert rel <= 1e-12, rel
