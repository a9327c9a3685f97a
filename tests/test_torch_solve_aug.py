"""The in-block factorizations ("facts") of the PyTorch port's banded kernels
(``mcp_tpu_torch/kernels/solve_aug.py``) held against the JAX package's own
``_solve_aug(M, b=b, fact=fact)`` (plain jnp code, called directly as
tests/test_tridiag.py calls the facts) on the same numpy inputs, in float64
on the CPU; and the kernel build's digest over the headers a source
includes."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcp_tpu.kernels import thomas_pallas as jtp
from mcp_tpu_torch.kernels import _build
from mcp_tpu_torch.kernels import solve_aug as SA

torch.set_num_threads(1)

PIVOTED = ("gjp", "gjpr", "gjbp", "gjbpr", "gjbpr2", "gjbprl")


def _blocks(S, b, nrhs, seed):
    """[A | N] with A = N(0, 1) + (b/2)·I: every fact's pivots stay away from
    zero, so the pivot-free facts solve it too."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((S, b, b)) + 0.5 * b * np.eye(b)
    return np.concatenate([A, rng.standard_normal((S, b, nrhs))], axis=2)


def _adversary(S, b, nrhs, seed, dtype=np.float64):
    """[A | N] with a structural zero leading pivot and row scales spread
    over 10^±3 (tests/test_tridiag.py's adversary of the pivoted facts)."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((S, b, b))
    A[:, 0, 0] = 0.0
    A = A * 10.0 ** rng.uniform(-3, 3, (S, b, 1))
    return np.concatenate([A, rng.standard_normal((S, b, nrhs))], axis=2).astype(dtype)


def _jax(M, b, fact):
    return np.asarray(jtp._solve_aug(jnp.asarray(M), b=b, fact=fact))


def _port(M, b, fact):
    return SA.solve_aug_plain(torch.from_numpy(M), b, fact).numpy()


@pytest.mark.parametrize("nc", ["3b+1", "b+1"])
@pytest.mark.parametrize("b", [4, 20, 40, 50, 100])
@pytest.mark.parametrize("fact", SA.FACTS)
def test_fact_matches_jax(fact, b, nc):
    """Every fact against the JAX function: the sweep's and CR's odd-block
    width 3b+1 and the base's b+1, with partial panels at b = 20, 50, 100.
    1e-11 of max|X|: the same eliminations in float64, the contractions
    summed in another order."""
    nrhs = 2 * b + 1 if nc == "3b+1" else 1
    M = _blocks(3, b, nrhs, seed=7 * b + nrhs)
    want, got = _jax(M, b, fact), _port(M, b, fact)
    assert got.shape == (3, b, nrhs)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-11 * np.abs(want).max())


@pytest.mark.parametrize("fact", SA.FACTS)
def test_structural_zero_pivot(fact):
    """tests/test_tridiag.py's block with a zero (0, 0) entry: the pivoted
    facts solve it; pivot-free Gauss–Jordan (gj, and gjb, one panel here)
    does not; every fact gives what the JAX function gives."""
    A = np.array([[[0.0, 2.0, 0.0, 0.0],
                   [1.0, 0.0, 0.0, 0.5],
                   [0.0, 0.3, 3.0, 0.0],
                   [0.2, 0.0, 0.0, 1.0]]])
    x_true = np.array([1.0, -2.0, 0.5, 3.0])
    M = np.concatenate([A, (A[0] @ x_true)[None, :, None]], axis=2)
    got, want = _port(M, 4, fact)[0, :, 0], _jax(M, 4, fact)[0, :, 0]
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)
    if fact in PIVOTED or fact == "qr":
        np.testing.assert_allclose(got, x_true, atol=1e-12)
    elif fact in ("gj", "gjb"):
        assert not np.allclose(got, x_true, atol=1e-3)


@pytest.mark.parametrize("refine", [0, 1, 2])
@pytest.mark.parametrize("b", [20, 50, 100])
def test_blocked_pivot_sequence_is_gjp(b, refine):
    """The blocked pivoted elimination picks gjp's pivot rows (right-looking
    blocking leaves the columns the search sees as they are), on the
    adversary and across panel boundaries."""
    M = torch.from_numpy(_adversary(3, b, 5, seed=b))
    _, p_gjp = SA._gjp_elimination(M, b)
    _, p_gjbp = SA._gjbp_elimination(M, b, refine)
    torch.testing.assert_close(p_gjbp, p_gjp, rtol=0, atol=0)
    assert sorted(p_gjp[0].tolist()) == list(range(b))


def test_refinement_restores_qr_accuracy():
    """tests/test_tridiag.py's envelope checks (``test_gjpr_refinement_cancels_
    pivot_growth``, ``test_gjbr_refinement_cancels_pivot_growth``) asserted on
    the port, on the same float32 blocks (row scales spread over 10^±3, drawn
    by jax.random as there): gjp and the pivot-free blocked gjb leave
    residuals far above QR's; one refinement step brings gjpr, gjbr and gjbpr
    back to QR's class. Each fact's residual is also the JAX function's, to
    a factor of 4 (float32 rounding of different summation orders)."""
    import jax

    TB, b = 64, 20
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(0), 3)
    A = jax.random.normal(k1, (TB, b, b), jnp.float32)
    A = A * 10.0 ** jax.random.uniform(k2, (TB, b, 1), minval=-3, maxval=3)
    N = jax.random.normal(k3, (TB, b, 5), jnp.float32)
    M = np.concatenate([np.asarray(A), np.asarray(N)], axis=2)
    A64, N64 = M[:, :, :b].astype(np.float64), M[:, :, b:].astype(np.float64)

    def residual(X):
        X = np.asarray(X, np.float64)
        return float(np.abs(N64 - A64 @ X).max() / np.abs(N64).max())

    r, r_jax = {}, {}
    for fact in ("qr", "gjp", "gjpr", "gjb", "gjbr", "gjbpr"):
        r[fact] = residual(SA.solve_aug_plain(torch.from_numpy(M), b, fact).numpy())
        r_jax[fact] = residual(jtp._solve_aug(jnp.asarray(M), b=b, fact=fact))
        assert r_jax[fact] / 4 <= r[fact] <= 4 * r_jax[fact], (fact, r, r_jax)
    assert r["gjp"] > 10 * r["qr"] and r["gjb"] > 10 * r["qr"], r
    assert r["gjpr"] < 3 * r["qr"] and r["gjbr"] < 5 * r["qr"], r
    assert r["gjbpr"] < 3 * r["qr"], r


@pytest.mark.parametrize("fact", SA.FACTS)
def test_zero_pivot_matches_jax(fact):
    """A singular block (zero row and column 2 in system 1): Gauss–Jordan
    clamps the pivot to 1e-30 and gives the JAX function's huge finite values
    there, QR divides by zero in both packages; system 0 is untouched."""
    b = 6
    rng = np.random.default_rng(3)
    A = rng.standard_normal((2, b, b)) + 3 * np.eye(b)
    A[1, :, 2] = 0.0
    A[1, 2, :] = 0.0
    M = np.concatenate([A, rng.standard_normal((2, b, 3))], axis=2)
    got, want = _port(M, b, fact), _jax(M, b, fact)
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-12 * np.abs(want[0]).max())
    if fact == "qr":
        assert not np.isfinite(got[1]).all() and not np.isfinite(want[1]).all()
        return
    assert np.isfinite(got[1]).all() and np.isfinite(want[1]).all()
    assert np.abs(want[1]).max() > 1e25
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=1e-12 * np.abs(want[1]).max())


def test_unknown_fact_raises():
    M = torch.from_numpy(_blocks(1, 3, 1, seed=0))
    with pytest.raises(ValueError, match="fact"):
        SA.solve_aug_plain(M, 3, "gjbpru")
    torch.testing.assert_close(SA.solve_aug_plain(M, 3, "lu"),
                               torch.linalg.solve(M[:, :, :3], M[:, :, 3:]))


def test_library_digest_covers_included_headers(tmp_path, monkeypatch):
    """Editing a copy of the shared header renames the library of every
    source that includes it, and of no other source."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for f in _build.CSRC.iterdir():
        (csrc / f.name).write_bytes(f.read_bytes())
    monkeypatch.setattr(_build, "CSRC", csrc)
    before = {n: _build.library_path(n) for n in _build.SOURCES}
    header = csrc / "solve_aug.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {n: _build.library_path(n) for n in _build.SOURCES}
    users = {n for n in _build.SOURCES if '#include "solve_aug.cuh"'
             in (csrc / f"{n}.cu").read_text()}
    assert users == {"thomas", "thomas_babe", "thomas_multi"}
    # K3 includes it through the slab header and K4b/K4c and K8b through the
    # group header, which the digest follows too.
    assert '#include "solve_aug_slab.cuh"' in (csrc / "cyclic_reduction.cu").read_text()
    assert '#include "solve_aug.cuh"' in (csrc / "solve_aug_slab.cuh").read_text()
    assert '#include "solve_aug_group.cuh"' in (csrc / "qr_dense.cu").read_text()
    assert '#include "solve_aug_group.cuh"' in (csrc / "wy_qr.cu").read_text()
    assert '#include "solve_aug.cuh"' in (csrc / "solve_aug_group.cuh").read_text()
    assert ({n for n in _build.SOURCES if before[n] != after[n]}
            == users | {"cyclic_reduction", "qr_dense", "wy_qr"})
    # The cluster primitives: K3 (through the slab header), K8a and K2.
    header = csrc / "cluster.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    again = {n: _build.library_path(n) for n in _build.SOURCES}
    assert ({n for n in _build.SOURCES if after[n] != again[n]}
            == {"cyclic_reduction", "qr_sep", "linesearch"})
