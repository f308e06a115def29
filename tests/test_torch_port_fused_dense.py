"""The port's ``dense_gelu_plain`` against the JAX package's Pallas kernel
``ops/fused_dense.py:_kernel`` run in ``interpret=True`` on the CPU, at
ragged shapes, in fp32 and bf16.

Tolerances: bf16 outputs within one bf16 ulp of the larger magnitude (the
two differ only by the fp32 summation order before the one cast; measured
<= 1 ulp, >= 99.99% exact); fp32 rtol 1e-5 / atol 1e-5 (measured <= 2.7e-6
absolute on O(1) outputs).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from jax.experimental import pallas as pl

from inference_efficient_vision_models_tpu.ops import fused_dense as jfd
from inference_efficient_vision_models_tpu_torch.ops import fused_dense as tfd


def jax_dense_gelu_interpret(x, w, b):
    """``fused_dense.dense_gelu`` as the TPU runs it (the module's own
    ``_kernel`` and ``_pick_blocks``), in Pallas interpret mode."""
    shape = x.shape
    k, n = w.shape
    m = int(np.prod(shape[:-1]))
    bm, bn = jfd._pick_blocks(k, n, jnp.dtype(x.dtype).itemsize)
    y = pl.pallas_call(
        jfd._kernel,
        grid=(-(-m // bm), -(-n // bn)),
        in_specs=[pl.BlockSpec((bm, k), lambda i, j: (i, 0)),
                  pl.BlockSpec((k, bn), lambda i, j: (0, j)),
                  pl.BlockSpec((1, bn), lambda i, j: (0, j))],
        out_specs=pl.BlockSpec((bm, bn), lambda i, j: (i, j)),
        out_shape=jax.ShapeDtypeStruct((m, n), x.dtype),
        interpret=True,
    )(x.reshape(-1, k), w, b.reshape(1, n))
    return y.reshape(*shape[:-1], n)


def assert_dense_close(got: np.ndarray, ref: np.ndarray, bf16: bool):
    assert got.shape == ref.shape and np.isfinite(got).all()
    d = np.abs(got - ref)
    if bf16:
        mag = np.maximum(np.abs(got), np.abs(ref))
        ulp = np.exp2(np.floor(np.log2(np.maximum(mag, 1e-30))) - 7)
        assert (d <= ulp).all(), (d / ulp).max()
        assert (d == 0).mean() >= 0.999, (d == 0).mean()
    else:
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,n", [((3, 7, 40), 24), ((130, 72), 168), ((5, 13), 37),
                                     ((1300, 64), 256), ((2, 197, 192), 768)])
def test_dense_gelu_plain_matches_pallas_kernel(shape, n, dtype):
    rng = np.random.default_rng(sum(shape) + n)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    x, w, b = (jnp.asarray(a, jdt) for a in (
        rng.standard_normal(shape),
        rng.standard_normal((shape[-1], n)) / np.sqrt(shape[-1]),
        rng.standard_normal(n)))
    ref = np.asarray(jax_dense_gelu_interpret(x, w, b).astype(jnp.float32))
    tdt = getattr(torch, dtype)
    xt, wt, bt = (torch.from_numpy(np.array(a.astype(jnp.float32))).to(tdt) for a in (x, w, b))
    out = tfd.dense_gelu(xt, wt, bt)  # a CPU tensor takes the plain version
    assert out.dtype == tdt and out.shape == (*shape[:-1], n)
    np.testing.assert_array_equal(out.float().numpy(), tfd.dense_gelu_plain(xt, wt, bt).float())
    assert_dense_close(out.float().numpy(), ref, dtype == "bfloat16")


def test_gelu_as_matches_exact_gelu():
    """The A&S erf GELU in fp32 stays within 1e-6 of the exact erf GELU taken
    in float64 over the GELU-relevant range (measured 4.6e-7)."""
    y = torch.linspace(-8, 8, 100001)
    d = (tfd.gelu_as(y).double() - torch.nn.functional.gelu(y.double(), approximate="none")).abs()
    assert float(d.max()) < 1e-6


def test_dense_gelu_rejects_bad_inputs():
    x = torch.zeros(4, 8)
    with pytest.raises(ValueError):
        tfd.dense_gelu(x.to("meta"), torch.zeros(8, 3), torch.zeros(3))
