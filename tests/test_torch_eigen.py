# Copyright 2026.
# SPDX-License-Identifier: Apache-2.0
"""The port's ``eigsh``, ``eigs``, ``lobpcg`` and ``svds`` against the
JAX package's, on the CPU.

Mirrors the cases of ``test_eigen.py`` that run in the default lane:
the same operators (built by scipy, from the same seeds) go to both
packages, and each result is held to the JAX package's.

Tolerances.  Eigenvalues agree to 1e-8 relative in float64 and
complex128, and to 2e-3 in float32 and complex64 (both run the same
recurrences; they differ in the order XLA and PyTorch sum a product,
and the float32 runs stop on a rounded residual estimate).  The
shift-invert, generalized and LOBPCG routes stop on residual tests
whose tolerance is above the eigenvalues' last digits, so their
eigenvalues are held at the JAX tests' own tolerances (1e-7 or 1e-6).
Eigenvectors are judged by their residuals (``‖A v − λ v‖`` or
``‖A v − λ M v‖``), never entry by entry: a sign, or a basis inside a
degenerate eigenspace, may differ.  Where both packages hand a case to
scipy on the host, the results are equal.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg as ssl
import torch
from scipy.sparse.linalg import ArpackError, ArpackNoConvergence

import legate_sparse_tpu as jsparse
import legate_sparse_tpu.linalg as jlinalg
from legate_sparse_tpu import eigen as jeigen

import legate_sparse_tpu_torch as tsparse
from legate_sparse_tpu_torch import eigen as teigen
from legate_sparse_tpu_torch import linalg as tlinalg
from legate_sparse_tpu_torch import runtime


@pytest.fixture(autouse=True)
def _cpu():
    runtime.set_device("cpu")
    yield
    runtime.set_device(None)


def lap1d(n, dtype=np.float64):
    main = np.full(n, 4.0)
    off = np.full(n - 1, -1.0)
    return sp.diags([off, main, off], [-1, 0, 1], format="csr").astype(dtype)


def hermitian(n, c, dtype=np.complex128):
    A = lap1d(n).astype(dtype)
    up = sp.diags([np.full(n - 1, c)], [1]).astype(dtype)
    return (A + 1j * up - 1j * up.T).tocsr()


def mass(n):
    # SPD tridiagonal mass matrix (FEM-style), strictly diagonally
    # dominant so the inner CG converges fast.
    return sp.diags([np.full(n - 1, 1.0), np.full(n, 4.0),
                     np.full(n - 1, 1.0)], [-1, 0, 1], format="csr") / 6.0


def tridiag_ns(n, seed, lo, hi, off=0.3):
    """Nonsymmetric, diagonally dominant, well separated spectrum."""
    rng = np.random.default_rng(seed)
    return sp.diags([np.linspace(lo, hi, n),
                     off * rng.uniform(-1, 1, n - 1),
                     off * rng.uniform(-1, 1, n - 1)], [0, 1, -1]).tocsr()


def pair(S):
    return jsparse.csr_array(S), tsparse.csr_array(S, device="cpu")


def host(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def sort_c(w):
    w = host(w)
    return w[np.lexsort((np.imag(w), np.real(w)))]


def same_values(wt, wj, rtol, atol=0.0):
    assert isinstance(wt, torch.Tensor)
    np.testing.assert_allclose(sort_c(wt), sort_c(wj), rtol=rtol, atol=atol)


def residuals(S, w, V, M=None):
    V, w = host(V), host(w)
    SV = S @ V
    MV = V if M is None else M @ V
    return np.linalg.norm(SV - MV * w[None, :], axis=0)


@pytest.fixture
def no_fallback(monkeypatch):
    """Fail the test if either package's eigen path reaches scipy."""
    def boom(name):
        raise AssertionError(f"_host_fallback({name!r}) on a native path")

    monkeypatch.setattr(teigen, "_host_fallback", boom)
    monkeypatch.setattr(jeigen, "_host_fallback", boom)


@pytest.fixture
def fallbacks(monkeypatch):
    """The names each package sends to scipy, in order."""
    used = {"torch": [], "jax": []}
    for key, mod in (("torch", teigen), ("jax", jeigen)):
        real = mod._host_fallback

        def spy(name, real=real, key=key):
            used[key].append(name)
            return real(name)

        monkeypatch.setattr(mod, "_host_fallback", spy)
    return used


# ---------------------------------------------------------------- eigsh


@pytest.mark.parametrize("which", ["LA", "SA", "LM"])
def test_eigsh_matches_jax(which):
    S = lap1d(120)
    J, T = pair(S)
    wj, _ = jlinalg.eigsh(J, k=4, which=which)
    wt, vt = tlinalg.eigsh(T, k=4, which=which)
    same_values(wt, wj, 1e-8)
    assert vt.device.type == "cpu" and vt.shape == (120, 4)
    assert np.all(residuals(S, wt, vt) < 1e-6)


def test_eigsh_f32_and_linear_operator():
    S = lap1d(90, np.float32)
    J, T = pair(S)
    wj, _ = jlinalg.eigsh(J, k=3, which="LA")
    wt, vt = tlinalg.eigsh(T, k=3, which="LA")
    assert wt.dtype == torch.float32 and vt.dtype == torch.float32
    same_values(wt, wj, 2e-3)
    assert np.all(residuals(S.astype(np.float64), wt.double(),
                            vt.double()) < 2e-3 * 6)
    op = tlinalg.LinearOperator(T.shape, matvec=lambda x: T @ x,
                                dtype=np.float32)
    same_values(tlinalg.eigsh(op, k=3, which="LA",
                              return_eigenvectors=False), wj, 2e-3)


def test_eigsh_complex_hermitian():
    H = hermitian(80, 0.5)
    J, T = pair(H)
    same_values(tlinalg.eigsh(T, k=3, which="LA")[0],
                jlinalg.eigsh(J, k=3, which="LA")[0], 1e-8)


def test_eigsh_shift_invert(no_fallback):
    S = lap1d(60)
    J, T = pair(S)
    wt, vt = tlinalg.eigsh(T, k=2, sigma=1.0)
    same_values(wt, jlinalg.eigsh(J, k=2, sigma=1.0)[0], 1e-8)
    assert np.all(residuals(S, wt, vt) < 1e-6)


@pytest.mark.parametrize("dtype,rtol,bound", [
    (np.float32, 2e-3, 2e-2), (np.float64, 1e-8, 1e-5)])
def test_eigsh_sigma_dtypes(no_fallback, dtype, rtol, bound):
    S = lap1d(80, dtype)
    J, T = pair(S)
    # An interior shift that is not an eigenvalue (3.0 is one for n=80).
    wt, vt = tlinalg.eigsh(T, k=3, sigma=3.3)
    wj, _ = jlinalg.eigsh(J, k=3, sigma=3.3)
    same_values(wt, wj, rtol)
    assert np.all(residuals(S.astype(np.float64), wt.double(),
                            vt.double()) < bound)


def test_eigsh_sigma_complex_hermitian(no_fallback):
    H = hermitian(64, 0.5)
    J, T = pair(H)
    wt, vt = tlinalg.eigsh(T, k=3, sigma=2.5)
    same_values(wt, jlinalg.eigsh(J, k=3, sigma=2.5)[0], 1e-7)
    assert np.all(residuals(H, wt, vt) < 1e-5)


def test_eigsh_sigma_complex64(no_fallback):
    H = hermitian(48, 0.5, np.complex64)
    J, T = pair(H)
    same_values(tlinalg.eigsh(T, k=2, sigma=2.0)[0],
                jlinalg.eigsh(J, k=2, sigma=2.0)[0], 2e-3)


def test_eigsh_sm(no_fallback):
    S = lap1d(80)
    J, T = pair(S)
    wt, vt = tlinalg.eigsh(T, k=3, which="SM")
    same_values(wt, jlinalg.eigsh(J, k=3, which="SM")[0], 1e-8)
    assert np.all(residuals(S, wt, vt) < 1e-6)


def test_eigsh_sm_with_explicit_sigma(no_fallback):
    # Under shift-invert SM is the transformed spectrum's: the
    # eigenvalues farthest from sigma.
    J, T = pair(lap1d(80))
    same_values(
        tlinalg.eigsh(T, k=2, sigma=3.3, which="SM",
                      return_eigenvectors=False),
        jlinalg.eigsh(J, k=2, sigma=3.3, which="SM",
                      return_eigenvectors=False), 1e-7)


def test_eigsh_sm_singular_falls_back_to_host(fallbacks):
    # The probe finds the singular operator and both packages hand the
    # call to scipy's direct SM mode: the same answer.
    S = sp.diags([np.arange(24, dtype=np.float64)], [0]).tocsr()
    J, T = pair(S)
    wt = tlinalg.eigsh(T, k=2, which="SM", return_eigenvectors=False)
    wj = jlinalg.eigsh(J, k=2, which="SM", return_eigenvectors=False)
    assert fallbacks == {"torch": ["eigsh"], "jax": ["eigsh"]}
    same_values(wt, wj, 0.0, atol=1e-8)


def test_eigsh_complex_sigma_raises():
    _, T = pair(lap1d(30))
    for sigma in (1.0 + 0.5j, 1.0 + 0j):
        with pytest.raises(TypeError):
            tlinalg.eigsh(T, k=2, sigma=sigma)


@pytest.mark.parametrize("k", [2, 3])
def test_eigsh_be(no_fallback, k):
    J, T = pair(lap1d(90))
    same_values(tlinalg.eigsh(T, k=k, which="BE", return_eigenvectors=False),
                jlinalg.eigsh(J, k=k, which="BE", return_eigenvectors=False),
                1e-8)


def test_eigsh_be_k1_raises_like_scipy():
    _, T = pair(lap1d(30))
    with pytest.raises(ArpackError):
        tlinalg.eigsh(T, k=1, which="BE")


def test_eigsh_invariant_subspace_breakdown():
    # The Krylov space is invariant at dimension 1: every step breaks
    # down and restarts from a fresh direction (the two packages draw
    # different ones), never padding T with fabricated zeros.
    wt, vt = tlinalg.eigsh(tsparse.eye(50, format="csr", device="cpu") * 2.0,
                           k=3, which="LA")
    wj, _ = jlinalg.eigsh(jsparse.eye(50, format="csr") * 2.0, k=3,
                          which="LA")
    same_values(wt, wj, 1e-10)
    np.testing.assert_allclose(host(wt), 2.0, rtol=1e-10)
    np.testing.assert_allclose(host(vt).T @ host(vt), np.eye(3), atol=1e-10)


def test_lanczos_try_fetches_once(monkeypatch):
    """A Lanczos try without a breakdown fetches its alphas, betas and
    breakdown flags once, through ``linalg._host_fetch``: no other
    transfer between its SpMVs."""
    fetches = []
    real = tlinalg._host_fetch
    monkeypatch.setattr(tlinalg, "_host_fetch",
                        lambda t: fetches.append(t.numel()) or real(t))
    _, T = pair(lap1d(200))
    with pytest.raises(ArpackNoConvergence):
        tlinalg.eigsh(T, k=2, which="LA", ncv=6, maxiter=3, tol=1e-30)
    assert fetches == [3 * 6, 3 * 12, 3 * 24]


# ---------------------------------------------------------- generalized


def test_eigsh_sigma_generalized(no_fallback):
    S = lap1d(40)
    J, T = pair(S)
    Mj, Mt = pair(sp.eye(40).tocsr() * 2.0)
    same_values(tlinalg.eigsh(T, k=2, sigma=1.0, M=Mt)[0],
                jlinalg.eigsh(J, k=2, sigma=1.0, M=Mj)[0], 1e-8)


def test_eigsh_sigma_generalized_mass_matrix(no_fallback):
    S, M = lap1d(80), mass(80)
    J, T = pair(S)
    Mj, Mt = pair(M)
    wt, vt = tlinalg.eigsh(T, k=3, sigma=3.1, M=Mt)
    same_values(wt, jlinalg.eigsh(J, k=3, sigma=3.1, M=Mj)[0], 1e-7)
    assert np.all(residuals(S, wt, vt, M) < 1e-5)


@pytest.mark.parametrize("which", ["LA", "SA", "LM"])
def test_eigsh_generalized(no_fallback, which):
    S, M = lap1d(80), mass(80)
    J, T = pair(S)
    Mj, Mt = pair(M)
    wt, vt = tlinalg.eigsh(T, k=3, M=Mt, which=which)
    same_values(wt, jlinalg.eigsh(J, k=3, M=Mj, which=which)[0], 1e-7)
    assert np.all(residuals(S, wt, vt, M) < 1e-5)
    v = host(vt)
    np.testing.assert_allclose(v.T @ (M @ v), np.eye(3), atol=1e-7)


def test_eigsh_be_generalized(no_fallback):
    J, T = pair(lap1d(72))
    Mj, Mt = pair(mass(72))
    same_values(
        tlinalg.eigsh(T, k=3, M=Mt, which="BE", return_eigenvectors=False),
        jlinalg.eigsh(J, k=3, M=Mj, which="BE", return_eigenvectors=False),
        1e-7)


def test_eigsh_generalized_sm_routes_through_shift_invert(no_fallback):
    J, T = pair(lap1d(64))
    Mj, Mt = pair(mass(64))
    same_values(
        tlinalg.eigsh(T, k=2, M=Mt, which="SM", return_eigenvectors=False),
        jlinalg.eigsh(J, k=2, M=Mj, which="SM", return_eigenvectors=False),
        1e-7)


@pytest.mark.parametrize("mode", ["buckling", "cayley"])
def test_eigsh_buckling_cayley(no_fallback, mode):
    S, M = lap1d(72), mass(72)
    J, T = pair(S)
    Mj, Mt = pair(M)
    wt, vt = tlinalg.eigsh(T, k=3, M=Mt, sigma=1.5, mode=mode)
    same_values(wt, jlinalg.eigsh(J, k=3, M=Mj, sigma=1.5, mode=mode)[0],
                1e-7)
    assert np.all(residuals(S, wt, vt, M) < 1e-5)


def test_eigsh_buckling_zero_sigma_raises():
    _, T = pair(lap1d(30))
    _, Mt = pair(mass(30))
    with pytest.raises(ValueError, match="nonzero sigma"):
        tlinalg.eigsh(T, k=2, M=Mt, sigma=0.0, mode="buckling")


def test_eigsh_generalized_bad_m_falls_back(monkeypatch, fallbacks):
    # A stagnating M-solve falls back to scipy rather than returning
    # silently wrong pairs.
    def boom(*a, **kw):
        raise ArpackNoConvergence("probe tripped", np.empty(0),
                                  np.empty((40, 0)))

    monkeypatch.setattr(teigen, "_eigsh_generalized", boom)
    S, M = lap1d(40), mass(40)
    _, T = pair(S)
    _, Mt = pair(M)
    w = tlinalg.eigsh(T, k=2, M=Mt, return_eigenvectors=False)
    assert fallbacks["torch"] == ["eigsh"]
    assert isinstance(w, torch.Tensor)
    np.testing.assert_allclose(
        np.sort(host(w)),
        np.sort(ssl.eigsh(S, k=2, M=M, return_eigenvectors=False)),
        rtol=1e-8)


# ---------------------------------------------------------------- lobpcg


@pytest.mark.parametrize("largest", [True, False])
def test_lobpcg_matches_jax(largest):
    S = lap1d(100)
    J, T = pair(S)
    X = np.random.default_rng(0).standard_normal((100, 3))
    iters = 300 if largest else 100
    wt, ut = tlinalg.lobpcg(T, X, maxiter=iters, largest=largest)
    wj, _ = jlinalg.lobpcg(J, X, maxiter=iters, largest=largest)
    np.testing.assert_allclose(host(wt), np.asarray(wj), rtol=1e-6)
    assert ut.shape == (100, 3)
    assert np.all(residuals(S, wt, ut) < 1e-4)


def test_lobpcg_standard_matches_jax():
    """The port's copy of jax's ``lobpcg_standard`` against jax's own on
    the same operator, X, m and tol: the eigenvalues to 1e-6, the
    iteration counts equal, the eigenvectors by their residuals."""
    import jax.numpy as jnp
    from jax.experimental.sparse.linalg import lobpcg_standard as jax_lobpcg

    from legate_sparse_tpu_torch._lobpcg import lobpcg_standard

    n, k = 150, 4
    S = lap1d(n)
    X = np.random.default_rng(3).standard_normal((n, k))
    for m, tol in ((40, None), (300, 1e-9)):
        tj, uj, ij = jax_lobpcg(jnp.asarray(S.toarray()), jnp.asarray(X),
                                m=m, tol=tol)
        tt, ut, it = lobpcg_standard(torch.from_numpy(S.toarray()),
                                     torch.from_numpy(X), m=m, tol=tol)
        np.testing.assert_allclose(tt.numpy(), np.asarray(tj), rtol=1e-6)
        assert it == int(ij)
        np.testing.assert_allclose(
            residuals(S, tt, ut),
            residuals(S, np.asarray(tj), np.asarray(uj)), rtol=1e-3)


def test_lobpcg_complex_hermitian(no_fallback):
    H = hermitian(72, 0.4)
    J, T = pair(H)
    X = np.random.default_rng(2).standard_normal((72, 3))
    wt, ut = tlinalg.lobpcg(T, X, largest=False)
    wj, _ = jlinalg.lobpcg(J, X, largest=False)
    same_values(wt, wj, 1e-7)
    assert np.all(residuals(H, wt, ut) < 1e-5)


def test_lobpcg_complex_nonconvergence_returns_not_raises():
    H = hermitian(72, 0.4)
    _, T = pair(H)
    X = np.random.default_rng(4).standard_normal((72, 3))
    with pytest.warns(UserWarning, match="did not converge"):
        w, U = tlinalg.lobpcg(T, X, maxiter=1, tol=1e-30, largest=False)
    assert w.shape == (3,) and U.shape == (72, 3)
    assert bool(torch.isfinite(w).all())


def test_lobpcg_generalized(no_fallback):
    S, B = lap1d(72), mass(72)
    J, T = pair(S)
    Bj, Bt = pair(B)
    X = np.random.default_rng(6).standard_normal((72, 3))
    wt, ut = tlinalg.lobpcg(T, X, B=Bt, largest=False)
    same_values(wt, jlinalg.lobpcg(J, X, B=Bj, largest=False)[0], 1e-6)
    assert np.all(residuals(S, wt, ut, B) < 1e-5)


def test_lobpcg_small_n_falls_back(fallbacks):
    S = sp.diags([np.arange(1.0, 17.0)], [0], format="csr")
    J, T = pair(S)
    X = np.random.default_rng(0).standard_normal((16, 4))
    wt, _ = tlinalg.lobpcg(T, X, maxiter=200)
    wj, _ = jlinalg.lobpcg(J, X, maxiter=200)
    assert fallbacks == {"torch": ["lobpcg"], "jax": ["lobpcg"]}
    np.testing.assert_allclose(np.sort(host(wt)), np.sort(np.asarray(wj)),
                               rtol=1e-12)
    np.testing.assert_allclose(np.sort(host(wt)), [13, 14, 15, 16],
                               atol=1e-3)


# ---------------------------------------------------------------- svds


def test_svds_rectangular():
    rng = np.random.default_rng(1)
    B = sp.random(80, 50, density=0.2, format="csr", random_state=rng)
    J, T = pair(B)
    U, s, Vh = tlinalg.svds(T, k=5)
    same_values(s, jlinalg.svds(J, k=5)[1], 1e-8)
    U, s, Vh = host(U), host(s), host(Vh)
    np.testing.assert_allclose(
        np.linalg.norm(B @ Vh.T - U * s[None, :], axis=0), 0, atol=1e-6)
    np.testing.assert_allclose(U.T @ U, np.eye(5), atol=1e-8)
    np.testing.assert_allclose(Vh @ Vh.T, np.eye(5), atol=1e-8)


def test_svds_sm_with_vectors(no_fallback):
    rng = np.random.default_rng(7)
    B = rng.standard_normal((36, 24)) + 3.0 * np.eye(36, 24)
    J, T = pair(sp.csr_array(B))
    U, s, Vt = tlinalg.svds(T, k=2, which="SM")
    same_values(s, jlinalg.svds(J, k=2, which="SM")[1], 1e-7)
    for i in range(2):
        np.testing.assert_allclose(B @ host(Vt)[i], host(s)[i] * host(U)[:, i],
                                   atol=1e-6)


def test_svds_rank_deficient():
    # The Gram operator has rank 5: breakdown must not make up singular
    # values above the true ones.
    B = np.zeros((30, 20))
    B[:5, :5] = np.diag([5.0, 4.0, 3.0, 2.0, 1.0])
    J, T = pair(sp.csr_array(B))
    st = tlinalg.svds(T, k=3, return_singular_vectors=False)
    sj = jlinalg.svds(J, k=3, return_singular_vectors=False)
    np.testing.assert_allclose(np.sort(host(st)), np.sort(np.asarray(sj)),
                               atol=1e-5)
    np.testing.assert_allclose(np.sort(host(st)), [3, 4, 5], atol=1e-5)


# ---------------------------------------------------------------- eigs


def test_eigs_sigma_real(no_fallback):
    S = tridiag_ns(60, 5, 1.0, 12.0)
    J, T = pair(S)
    wt, vt = tlinalg.eigs(T, k=3, sigma=5.03)
    assert wt.dtype == torch.complex128
    same_values(wt, jlinalg.eigs(J, k=3, sigma=5.03)[0], 1e-6, atol=1e-8)
    assert np.all(residuals(S, wt, vt) < 1e-5)


def test_eigs_sigma_complex_shift(no_fallback):
    S = tridiag_ns(50, 9, 1.0, 10.0)
    J, T = pair(S)
    sigma = 4.55 + 0.3j       # a complex shift on a real operator
    same_values(tlinalg.eigs(T, k=2, sigma=sigma)[0],
                jlinalg.eigs(J, k=2, sigma=sigma)[0], 1e-6, atol=1e-8)


def test_eigs_sm(no_fallback):
    S = tridiag_ns(50, 8, 1.0, 9.0, off=0.2)
    J, T = pair(S)
    same_values(tlinalg.eigs(T, k=2, which="SM")[0],
                jlinalg.eigs(J, k=2, which="SM")[0], 1e-6, atol=1e-8)


def test_eigs_symmetric_lm():
    # Arnoldi in real arithmetic on a symmetric operator: the
    # eigenvalues come back complex with zero imaginary parts.
    S = lap1d(120)
    J, T = pair(S)
    wt, vt = tlinalg.eigs(T, k=4, which="LM")
    same_values(wt, jlinalg.eigs(J, k=4, which="LM")[0], 1e-8)
    assert wt.is_complex() and float(wt.imag.abs().max()) == 0.0
    assert np.all(residuals(S, wt, vt) < 1e-6)


def test_eigs_generalized(no_fallback):
    S, M = tridiag_ns(60, 3, 1.0, 9.0), mass(60)
    J, T = pair(S)
    Mj, Mt = pair(M)
    wt, vt = tlinalg.eigs(T, k=3, M=Mt, which="LM")
    same_values(wt, jlinalg.eigs(J, k=3, M=Mj, which="LM")[0], 1e-6)
    assert np.all(residuals(S, wt, vt, M) < 1e-5)


def test_eigs_generalized_shift_invert(no_fallback):
    S, M = tridiag_ns(56, 4, 1.0, 10.0, off=0.25), mass(56)
    J, T = pair(S)
    Mj, Mt = pair(M)
    wt, vt = tlinalg.eigs(T, k=2, M=Mt, sigma=5.02)
    same_values(wt, jlinalg.eigs(J, k=2, M=Mj, sigma=5.02)[0], 1e-6,
                atol=1e-8)
    assert np.all(residuals(S, wt, vt, M) < 1e-5)


def test_eigs_generalized_returns_complex_dtype(no_fallback):
    _, T = pair(tridiag_ns(40, 1, 1.0, 8.0, off=0.2))
    _, Mt = pair(mass(40))
    w = tlinalg.eigs(T, k=2, M=Mt, return_eigenvectors=False)
    assert w.is_complex()


def test_eigs_sm_sigma_near_eigenvalue_falls_back(fallbacks):
    S = sp.diags([np.arange(1.0, 41.0)], [0]).tocsr()
    J, T = pair(S)
    wt = tlinalg.eigs(T, k=2, sigma=3.0 + 1e-13, which="SM",
                      return_eigenvectors=False)
    wj = jlinalg.eigs(J, k=2, sigma=3.0 + 1e-13, which="SM",
                      return_eigenvectors=False)
    assert fallbacks == {"torch": ["eigs"], "jax": ["eigs"]}
    same_values(wt, wj, 1e-6)


# ------------------------------------------------------- no convergence


def _raised(fn):
    with pytest.raises(ArpackNoConvergence) as ei:
        fn()
    return ei.value


def test_no_convergence_raises_like_jax():
    # Both raise scipy's class with the same converged subset.
    rng = np.random.default_rng(3)
    n = 400
    A = sp.csr_array(sp.random(n, n, density=0.05, random_state=rng)
                     + 5 * sp.eye(n))
    S = sp.csr_array((A + A.T) / 2)
    for fn, mat in (("eigs", A), ("eigsh", S)):
        J, T = pair(mat)
        et = _raised(lambda: getattr(tlinalg, fn)(T, k=4, ncv=6, maxiter=1,
                                                  tol=1e-14))
        ej = _raised(lambda: getattr(jlinalg, fn)(J, k=4, ncv=6, maxiter=1,
                                                  tol=1e-14))
        assert et.eigenvalues.ndim == 1
        assert et.eigenvalues.shape == ej.eigenvalues.shape
        assert et.eigenvectors.shape == (n, et.eigenvalues.size)
        np.testing.assert_allclose(sort_c(et.eigenvalues),
                                   sort_c(ej.eigenvalues), rtol=1e-8)


def test_no_convergence_final_try_doubling_still_raises():
    # ncv=24 on n=40 with one try: m would double past n after the
    # failed try, but the checks judge the m that ran.
    rng = np.random.default_rng(7)
    n = 40
    A = sp.csr_array(rng.standard_normal((n, n)))
    S = sp.csr_array((A + A.T) / 2)
    for fn, mat in (("eigs", A), ("eigsh", S)):
        J, T = pair(mat)
        et = _raised(lambda: getattr(tlinalg, fn)(T, k=4, ncv=24, maxiter=1,
                                                  tol=1e-30))
        ej = _raised(lambda: getattr(jlinalg, fn)(J, k=4, ncv=24, maxiter=1,
                                                  tol=1e-30))
        assert et.eigenvalues.shape == ej.eigenvalues.shape
