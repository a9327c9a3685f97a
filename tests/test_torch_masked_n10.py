"""The masked game at N=10 (blocks of b=100, the N=10 flagship's width) at
horizon 2, in the PyTorch port against the JAX package, in float64 on the
CPU: the game build and the residual at one probe point. N=10 is where the
port's shared-constraint gradient (taken once over the joint primal, not
once per player) differs most from the JAX package's per-player sum, so
the residual is held to the same 1e-12 as at N=4. The JAX build takes about
a minute on the CPU, so the horizon is the shortest with a time coupling."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcp_tpu.bench.flagships import masked_game_setup as jax_setup
from mcp_tpu_torch.bench.flagships import masked_game_setup

torch.set_num_threads(1)


@functools.lru_cache(maxsize=None)
def _setup():
    js = jax_setup(1, 10, 2)
    ts = masked_game_setup(1, 10, 2, device="cpu", dtype=torch.float64)
    return js, ts, np.asarray(js.thetas, dtype=np.float64)[0]


def test_game_build_matches_jax():
    js, ts, _ = _setup()
    jm, tm = js.mcp, ts.mcp
    assert (tm.unconstrained_dimension, tm.constrained_dimension, tm.parameter_dimension) == (
        jm.unconstrained_dimension, jm.constrained_dimension, jm.parameter_dimension)
    jst, tst = jm.time_structure, tm.time_structure
    assert tuple(tst.permutation) == tuple(jst.permutation)
    assert tuple(tst.row_permutation) == tuple(jst.row_permutation)
    assert (tst.num_blocks, tst.block_size, tst.rows_per_block) == (
        jst.num_blocks, jst.block_size, jst.rows_per_block) == (2, 100, 121)
    assert jm.affine_bands is None and tm.affine_bands is None


@pytest.mark.parametrize("part", ["g", "h"])
def test_residual_matches_jax(part):
    js, ts, theta = _setup()
    rng = np.random.default_rng(0)
    x = 0.3 * rng.standard_normal(ts.mcp.unconstrained_dimension)
    y = 1.0 + 0.1 * rng.random(ts.mcp.constrained_dimension)
    want = js.mcp.gh(jnp.asarray(x), jnp.asarray(y), jnp.asarray(theta))
    got = ts.mcp.gh(*(torch.from_numpy(a) for a in (x, y, theta)))
    i = "gh".index(part)
    np.testing.assert_allclose(got[i].numpy(), np.asarray(want[i]), rtol=0, atol=1e-12)
