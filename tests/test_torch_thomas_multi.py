"""K6, the multi-right-hand-side block-Thomas sweep, in the PyTorch port
against the JAX package: the plain version against
``pallas_block_thomas_multi`` in interpret mode, the port's plain LU
``block_thomas_solve_multi`` against the JAX package's, a band shared by
every system (batch stride 0) and slab views of longer bands (the SPIKE
stage's operands), and the wrapper's checks; float64 on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcp_tpu.kernels import block_tridiag as JBT
from mcp_tpu.kernels import thomas_pallas as jtp
from mcp_tpu_torch.kernels import block_tridiag as TBT
from mcp_tpu_torch.kernels import thomas_multi as K6

torch.set_num_threads(1)


def _bands(B, T, b, k, seed):
    rng = np.random.default_rng(seed)
    return (
        rng.standard_normal((B, T, b, b)) + 6 * np.eye(b),
        0.3 * rng.standard_normal((B, T - 1, b, b)),
        0.3 * rng.standard_normal((B, T - 1, b, b)),
        rng.standard_normal((B, T, b, k)),
    )


def _t(arrs):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrs)


@pytest.mark.parametrize("T", [1, 2, 5])
def test_plain_matches_the_jax_kernel(T):
    arrs = _bands(3, T, 4, 9, seed=T)
    want = np.asarray(jtp.pallas_block_thomas_multi(*(jnp.asarray(a) for a in arrs),
                                                    interpret=True))
    got = K6.thomas_solve_multi(*_t(arrs)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12 * np.abs(want).max())


@pytest.mark.parametrize("T", [1, 2, 5])
def test_lu_slab_solve_matches_jax(T):
    arrs = _bands(3, T, 4, 9, seed=10 + T)
    want = np.asarray(jax.vmap(JBT.block_thomas_solve_multi)(*(jnp.asarray(a) for a in arrs)))
    got = TBT.block_thomas_solve_multi(*_t(arrs)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12 * np.abs(want).max())


def test_shared_band_is_the_expanded_band():
    """lower/upper expanded over the batch (stride 0) give what per-system
    copies give, bit for bit."""
    diag, lower, upper, rhs = _t(_bands(4, 5, 6, 13, seed=20))
    lo, up = lower[:1].expand(4, -1, -1, -1), upper[:1].expand(4, -1, -1, -1)
    assert lo.stride(0) == 0
    got = K6.thomas_solve_multi(diag, lo, up, rhs)
    want = K6.thomas_solve_multi(diag, lo.contiguous(), up.contiguous(), rhs)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_slab_views_are_taken_as_they_are():
    """A T-slab view of longer bands (batch stride T·b·b, not Tl·b·b) solves
    as its contiguous copy."""
    diag, lower, upper, _ = _t(_bands(3, 10, 4, 1, seed=21))
    rhs = torch.from_numpy(np.random.default_rng(22).standard_normal((3, 5, 4, 9)))
    views = (diag[:, 5:], lower[:, 5:9], upper[:, 5:9])
    assert K6._system_stride(views[0], "diag") == 10 * 16
    got = K6.thomas_solve_multi(*views, rhs)
    want = K6.thomas_solve_multi(*(v.contiguous() for v in views), rhs)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    # ... and solves the slab's own system.
    x1 = TBT.block_thomas_solve_multi(*(v.contiguous() for v in views), rhs)
    torch.testing.assert_close(got, x1, rtol=0, atol=1e-12)


def test_wrapper_checks_and_counts_no_cpu_launch():
    diag, lower, upper, rhs = _t(_bands(2, 3, 4, 5, seed=23))
    before = K6.thomas_solve_multi.launches
    K6.thomas_solve_multi(diag, lower, upper, rhs)
    assert K6.thomas_solve_multi.launches == before
    with pytest.raises(ValueError, match="rhs must be"):
        K6.thomas_solve_multi(diag, lower, upper, rhs[..., 0])
    with pytest.raises(ValueError, match="lower must be"):
        K6.thomas_solve_multi(diag, lower[:, :1], upper, rhs)
    with pytest.raises(ValueError, match="share dtype"):
        K6.thomas_solve_multi(diag, lower, upper, rhs.float())
    with pytest.raises(ValueError, match="contiguous within a system"):
        K6.thomas_solve_multi(diag.transpose(2, 3), lower, upper, rhs)
    with pytest.raises(ValueError, match="fact"):
        K6.thomas_solve_multi(diag, lower, upper, rhs, fact="gjp")
    with pytest.raises(ValueError, match="float32/float64"):
        K6.thomas_solve_multi(*(a.half() for a in (diag, lower, upper, rhs)))


def test_shared_memory_plan():
    """The card takes the SPIKE shapes beyond the TPU's 3b + k ≤ 128 lane
    rule (b = 40, k = 81 in float64: ~105 KB) and refuses what does not fit
    one block (232,448 bytes)."""
    from mcp_tpu_torch.kernels.thomas import check_fits, sweep_smem_bytes

    assert sweep_smem_bytes(20, "qr", 4, 41) < 16 * 1024
    assert sweep_smem_bytes(40, "qr", 8, 81) < 110 * 1024
    check_fits(40, "qr", torch.float64, k=81)
    with pytest.raises(ValueError, match="k=193"):
        check_fits(64, "qr", torch.float64, name="thomas_solve_multi", k=193)
