# Copyright 2026.
# SPDX-License-Identifier: Apache-2.0
"""The port's compressed storage (``csr_array.compress``/
``astype_storage``: bf16 values, int16 column indices), its widening
routes, the f32-accumulation and sliced-ELL ops, ``refine=`` on
``cg``/``gmres`` and the npz round trip, against the JAX package on
the CPU.

Mirrors the single-device cases of ``test_compressed_storage.py``.
The same scipy matrices, made from a seed, go to both packages; the
port runs on ``device="cpu"``.  Route labels are read from the JAX
package's ``spmv``/``spmm`` spans; its ``"dia-xla"``/``"dia-xla-nopad"``
is the port's ``"dia-torch"``.

Tolerances.  Storage, indices and the gather-class products (ELL rows
and CSR segments summed in stored order, DIA shifted adds in offset
order) are held bit for bit.  Against float64 scipy over the rounded
values the f32 routes are held at rtol 1e-4, atol 1e-5 (f32
accumulation, the JAX package's bound), a bf16 result at 0.05.
``refine=`` is held to equal cycles, inner iterations and fetch counts,
and the solutions at 1e-9 (f64 system) and 1e-4 (f32 system) of their
norm: the inner solves run the same arithmetic in each package and sum
dot products in another order.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax.numpy as jnp

import legate_sparse_tpu as jsparse
import legate_sparse_tpu.linalg as jlinalg
from legate_sparse_tpu import gallery as jgallery
from legate_sparse_tpu import io as jio
from legate_sparse_tpu import obs as jobs
from legate_sparse_tpu.ops import spmv as jspmv

import legate_sparse_tpu_torch as tsparse
from legate_sparse_tpu_torch import io as tio
from legate_sparse_tpu_torch import linalg as tlinalg
from legate_sparse_tpu_torch import obs as tobs
from legate_sparse_tpu_torch import runtime
from legate_sparse_tpu_torch.ops import spmv as tspmv

# The JAX package's label for each of the port's where they differ.
JAX_LABEL = {"dia-torch": ("dia-xla", "dia-xla-nopad"),
             "dia-kernel": ("dia-pallas",)}


@pytest.fixture(autouse=True)
def _isolation():
    runtime.set_device("cpu")
    jobs.reset_all()
    tobs.reset_all()
    jobs.trace.disable()
    yield
    jobs.trace.disable()
    jobs.reset_all()
    tobs.reset_all()
    runtime.set_device(None)


def random_csr(n, m=None, density=0.08, seed=0, spd=False):
    m = n if m is None else m
    rng = np.random.default_rng(seed)
    A = sp.random(n, m, density=density, random_state=rng, format="csr",
                  dtype=np.float64)
    if spd:
        A = (A + A.T + 10.0 * sp.eye(n)).tocsr()
    return A.astype(np.float32)


def holey_tridiag(n=64, hole=10):
    """Tridiagonal without the (hole, hole) entry: a band with a hole."""
    rows, cols, vals = [], [], []
    for i in range(n):
        for j in (i - 1, i, i + 1):
            if 0 <= j < n and not (i == j == hole):
                rows.append(i)
                cols.append(j)
                vals.append(1.0 + 0.01 * i + 0.5 * (i == j))
    return sp.csr_matrix((np.asarray(vals, np.float32), (rows, cols)),
                         shape=(n, n)).tocsr()


def structure(name):
    if name == "banded":
        return sp.diags([np.linspace(0.5, 1.5, 255),
                         np.linspace(2.0, 3.0, 256),
                         np.linspace(-1.0, 1.0, 255)],
                        [-1, 0, 1]).tocsr().astype(np.float32)
    if name == "holey":
        return holey_tridiag(256)
    if name == "powerlaw":
        P = jgallery.powerlaw(256, nnz_per_row=4, rng=5, dtype=np.float32)
        P.sum_duplicates()
        return sp.csr_array((np.asarray(P.data), np.asarray(P.indices),
                             np.asarray(P.indptr)), shape=P.shape)
    return random_csr(256, density=0.05, seed=4)


def pair(S):
    return jsparse.csr_array(S), tsparse.csr_array(S, device="cpu")


def host(t):
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


def bits(a):
    """Raw 16-bit patterns of a bf16 array of either package."""
    if isinstance(a, torch.Tensor):
        return a.view(torch.int16).numpy().view(np.uint16)
    return np.asarray(a).view(np.uint16)


def jax_path(kind):
    return [r for r in jobs.records() if r["name"] == kind][-1]["attrs"][
        "path"]


def same_label(port, jax):
    assert jax == port or jax in JAX_LABEL.get(port, ()), (port, jax)


def scipy_ref(C, x):
    """float64 scipy product over the port's stored (rounded) values."""
    data, indices, indptr = (host(C.data).astype(np.float64),
                             C.indices.numpy().astype(np.int64),
                             C.indptr.numpy())
    return sp.csr_matrix((data, indices, indptr), shape=C.shape) @ \
        np.asarray(x, np.float64)


# ------------------------------------------------------ representation


def test_compress_defaults_bf16_int16():
    Aj, At = pair(random_csr(256, seed=1))
    Cj, Ct = Aj.compress(), At.compress()
    assert Ct.dtype == torch.bfloat16 and Ct.indices.dtype == torch.int16
    assert str(Cj.dtype) == "bfloat16"
    assert np.dtype(Cj.indices.dtype) == np.int16
    assert Ct.shape == At.shape and Ct.nnz == At.nnz
    # The original is untouched; the structure is shared.
    assert At.dtype == torch.float32 and At.indices.dtype == torch.int32
    assert Ct.indptr is At.indptr
    assert np.array_equal(bits(Ct.data), bits(Cj.data))
    np.testing.assert_array_equal(Ct.indices.numpy(), np.asarray(Cj.indices))
    np.testing.assert_array_equal(Ct.indptr.numpy(), np.asarray(Cj.indptr))


def test_compress_auto_keeps_int32_when_columns_overflow_int16():
    S = random_csr(8, (1 << 15) + 8, density=0.01, seed=2)
    Aj, At = pair(S)
    Ct = At.compress()
    assert Ct.dtype == torch.bfloat16 and Ct.indices.dtype == torch.int32
    assert np.dtype(Aj.compress().indices.dtype) == np.int32
    # The largest extent int16 holds takes it.
    Ct = tsparse.csr_array(random_csr(4, 1 << 15, density=0.01),
                           device="cpu").compress()
    assert Ct.indices.dtype == torch.int16


def test_compress_rejects_bad_storage_dtypes():
    wide = random_csr(8, (1 << 15) + 8, density=0.01)
    for pkg in (jsparse, tsparse):
        kw = {} if pkg is jsparse else {"device": "cpu"}
        A = pkg.csr_array(random_csr(64), **kw)
        with pytest.raises(ValueError, match="overflows"):
            pkg.csr_array(wide, **kw).compress(indices="int16")
        with pytest.raises(ValueError, match="signed integer"):
            A.compress(indices="float32")
        with pytest.raises(NotImplementedError, match="not supported"):
            A.compress(values="float16")


def test_astype_storage_widens_back_exactly():
    Aj, At = pair(random_csr(128, seed=3))
    Ct = At.compress()
    W = Ct.astype_storage(values="float32", indices="int32")
    assert W.dtype == torch.float32 and W.indices.dtype == torch.int32
    assert torch.equal(W.data, Ct.data.float())
    Wj = Aj.compress().astype_storage(values="float32", indices="int32")
    np.testing.assert_array_equal(W.data.numpy(), np.asarray(Wj.data))
    K = Ct.astype_storage()
    assert K.dtype == torch.bfloat16 and K.indices.dtype == torch.int16
    C2 = At.compress(copy=True)
    assert C2.indices.dtype == torch.int16


# ------------------------------------------- widening routes vs the JAX


@pytest.mark.parametrize("name,path", [("uniform", "ell-bf16"),
                                       ("powerlaw", "csr-rowids-bf16"),
                                       ("banded", "dia-torch"),
                                       ("holey", "dia-torch")])
def test_lowp_spmv_matches_jax_and_scipy(name, path):
    S = structure(name)
    Aj, At = pair(S)
    Cj, Ct = Aj.compress(), At.compress()
    x = np.linspace(-1.0, 1.0, S.shape[1]).astype(np.float32)
    jobs.trace.enable()
    yj = np.asarray(Cj @ jnp.asarray(x))
    yt = Ct @ torch.from_numpy(x)
    assert Ct.spmv_path == path
    same_label(path, jax_path("spmv"))
    assert yt.dtype == torch.float32
    np.testing.assert_array_equal(yt.numpy(), yj)
    np.testing.assert_allclose(yt.numpy(), scipy_ref(Ct, x), rtol=1e-4,
                               atol=1e-5)


@pytest.mark.parametrize("name,path", [("uniform", "csr-rowids-bf16"),
                                       ("banded", "dia-torch")])
def test_lowp_spmm_matches_jax_and_scipy(name, path):
    S = structure(name)
    Aj, At = pair(S)
    Cj, Ct = Aj.compress(), At.compress()
    X = np.linspace(-1.0, 1.0, S.shape[1] * 3).reshape(-1, 3).astype(
        np.float32)
    jobs.trace.enable()
    Yj = np.asarray(Cj @ jnp.asarray(X))
    Yt = Ct @ torch.from_numpy(X)
    assert Ct.spmm_path == path and Yt.dtype == torch.float32
    same_label(path, jax_path("spmm"))
    np.testing.assert_array_equal(Yt.numpy(), Yj)
    ref = np.stack([scipy_ref(Ct, X[:, j]) for j in range(3)], axis=1)
    np.testing.assert_allclose(Yt.numpy(), ref, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("name,path", [("uniform", "ell"),
                                       ("powerlaw", "csr-rowids")])
def test_same_dtype_bf16_spmv_stays_bf16(name, path):
    """A bf16 operand is not the widening: the bf16 paths run, bf16
    out (on the card the DIA and BSR kernels, as the JAX package takes
    Pallas)."""
    S = structure(name)
    Aj, At = pair(S)
    Cj, Ct = Aj.compress(), At.compress()
    x = np.linspace(0.1, 1.0, S.shape[1]).astype(np.float32)
    jobs.trace.enable()
    yj = Cj @ jnp.asarray(x, jnp.bfloat16)
    yt = Ct @ torch.from_numpy(x).to(torch.bfloat16)
    assert yt.dtype == torch.bfloat16 and Ct.spmv_path == path
    same_label(path, jax_path("spmv"))
    assert np.array_equal(bits(yt), bits(yj))
    np.testing.assert_allclose(host(yt), scipy_ref(Ct, host(
        torch.from_numpy(x).to(torch.bfloat16))), rtol=0.05, atol=0.05)


def test_lowp_rule_cases():
    """Which operand dtypes widen: another dtype whose result type is
    f32 (f32, f16); not bf16 itself, not f64 (the matrix casts up)."""
    _, At = pair(random_csr(64, seed=9))
    Ct = At.compress()
    x = torch.linspace(-1.0, 1.0, 64)
    assert Ct._lowp(torch.float32) and Ct._lowp(torch.float16)
    assert not Ct._lowp(torch.bfloat16) and not Ct._lowp(torch.float64)
    assert not At._lowp(torch.bfloat16)
    y64 = Ct @ x.double()
    assert y64.dtype == torch.float64 and Ct.spmv_path == "csr"


# -------------------------------------------------------- DIA mask trade


def test_compressed_dia_drops_mask_f32_keeps_it():
    _, At = pair(holey_tridiag())
    dia = At._get_dia()
    assert dia is not None and dia[2] is not None
    Ct = At.compress()
    assert Ct._get_dia()[2] is None
    # Compressed indices alone keep the mask: the trade is the values'.
    N = At.astype_storage(indices="int16")
    assert N.indices.dtype == torch.int16 and N._get_dia()[2] is not None


def test_compressed_dia_nonfinite_hole_trade():
    hole = 10
    Aj, At = pair(holey_tridiag(hole=hole))
    x = np.linspace(0.5, 1.5, At.shape[0]).astype(np.float32)
    x[hole] = np.inf
    y32 = At @ torch.from_numpy(x)
    assert bool(torch.isfinite(y32[hole]))
    yc = (At.compress() @ torch.from_numpy(x)).numpy()
    assert np.isnan(yc[hole])
    yj = np.asarray(Aj.compress() @ jnp.asarray(x))
    np.testing.assert_array_equal(yc, yj)


def test_compressed_dia_finite_parity():
    Aj, At = pair(holey_tridiag())
    x = np.linspace(-2.0, 2.0, At.shape[0]).astype(np.float32)
    yt = At.compress() @ torch.from_numpy(x)
    assert yt.dtype == torch.float32
    np.testing.assert_array_equal(yt.numpy(),
                                  np.asarray(Aj.compress() @ jnp.asarray(x)))
    np.testing.assert_allclose(yt.numpy(), scipy_ref(At.compress(), x),
                               rtol=1e-4, atol=1e-5)


# ------------------------------------------------------- npz round trip


def test_npz_roundtrip_both_directions(tmp_path):
    Aj, At = pair(random_csr(200, seed=12))
    Cj, Ct = Aj.compress(), At.compress()
    from_jax, from_port = tmp_path / "jax.npz", tmp_path / "port.npz"
    jio.save_npz(str(from_jax), Cj)
    tio.save_npz(str(from_port), Ct)
    Lt = tio.load_npz(str(from_jax), device="cpu")
    Lj = jio.load_npz(str(from_port))
    for L in (Lt, tio.load_npz(str(from_port), device="cpu")):
        assert L.dtype == torch.bfloat16 and L.indices.dtype == torch.int16
        assert np.array_equal(bits(L.data), bits(Cj.data))
        np.testing.assert_array_equal(L.indices.numpy(),
                                      np.asarray(Cj.indices))
        np.testing.assert_array_equal(L.indptr.numpy(),
                                      np.asarray(Cj.indptr))
    assert str(Lj.dtype) == "bfloat16"
    assert np.dtype(Lj.indices.dtype) == np.int16
    assert np.array_equal(bits(Lj.data), bits(Ct.data))
    np.testing.assert_array_equal(np.asarray(Lj.indices), Ct.indices.numpy())
    x = np.linspace(-1.0, 1.0, 200).astype(np.float32)
    np.testing.assert_array_equal((Lt @ torch.from_numpy(x)).numpy(),
                                  np.asarray(Lj @ jnp.asarray(x)))


# -------------------------------------------------------------- refine=


def _refine_pair(solve_t, solve_j, solver, At, Aj, b, rtol):
    xt, it_t = solve_t(At, torch.from_numpy(b), rtol=rtol, atol=0.0,
                       refine="auto")
    xj, it_j = solve_j(Aj, jnp.asarray(b), rtol=rtol, atol=0.0,
                       refine="auto")
    key = f"transfer.host_sync.{solver}_refine"
    cycles_t, cycles_j = tobs.counters.get(key), jobs.counters.get(key)
    assert cycles_t == cycles_j >= 1
    assert int(it_t) == int(it_j) > 0
    assert (tobs.counters.get(f"op.{solver}")
            == jobs.counters.get(f"op.{solver}"))
    return xt, np.asarray(xj), cycles_t


def test_cg_refine_f32_system_matches_jax():
    S = random_csr(120, density=0.05, seed=15, spd=True)
    Aj, At = pair(S)
    b = np.linspace(0.5, 1.5, 120).astype(np.float32)
    xt, xj, _ = _refine_pair(tlinalg.cg, jlinalg.cg, "cg", At, Aj, b, 1e-6)
    resid = float(torch.linalg.vector_norm(torch.from_numpy(b) - At @ xt))
    assert resid <= 1e-6 * float(np.linalg.norm(b)) * 1.05
    np.testing.assert_allclose(xt.numpy(), xj, rtol=0,
                               atol=1e-4 * np.abs(xj).max())
    assert tlinalg._refine_inner_operator(At).dtype == torch.bfloat16


def test_cg_refine_f64_system_uses_f32_inner():
    S = random_csr(120, density=0.05, seed=16, spd=True).astype(np.float64)
    Aj, At = pair(S)
    b = np.linspace(0.5, 1.5, 120)
    xt, xj, _ = _refine_pair(tlinalg.cg, jlinalg.cg, "cg", At, Aj, b, 1e-10)
    resid = float(torch.linalg.vector_norm(torch.from_numpy(b) - At @ xt))
    assert resid <= 1e-10 * float(np.linalg.norm(b)) * 1.05
    np.testing.assert_allclose(xt.numpy(), xj, rtol=0,
                               atol=1e-9 * np.abs(xj).max())
    inner = tlinalg._refine_inner_operator(At)
    assert inner.dtype == torch.float32 and inner.indices.dtype == torch.int16


def test_gmres_refine_matches_jax():
    rng = np.random.default_rng(17)
    S = sp.random(80, 80, density=0.08, random_state=rng, format="csr",
                  dtype=np.float64)
    S = (S + 12.0 * sp.eye(80)).tocsr().astype(np.float32)
    Aj, At = pair(S)
    b = np.linspace(0.5, 1.5, 80).astype(np.float32)
    xt, xj, _ = _refine_pair(tlinalg.gmres, jlinalg.gmres, "gmres", At, Aj,
                             b, 1e-6)
    resid = float(torch.linalg.vector_norm(torch.from_numpy(b) - At @ xt))
    assert resid <= 1e-6 * float(np.linalg.norm(b)) * 1.05
    assert (tobs.counters.get("transfer.host_sync.gmres_conv")
            == jobs.counters.get("transfer.host_sync.gmres_conv"))


def test_refine_rejects_bad_compositions():
    S = random_csr(32, density=0.2, seed=18, spd=True)
    _, At = pair(S)
    b = torch.ones(32)
    with pytest.raises(ValueError, match="composes with neither"):
        tlinalg.cg(At, b, refine="auto", M=sp.eye(32).tocsr())
    with pytest.raises(ValueError, match="composes with neither"):
        tlinalg.gmres(At, b, refine="auto", callback=lambda x: None)
    with pytest.raises(ValueError, match="positive cycle count"):
        tlinalg.cg(At, b, refine=0)
    with pytest.raises(ValueError, match="float32/float64"):
        tlinalg.cg(At.compress(), b, refine="auto")
    with pytest.raises(ValueError, match="sparse-matrix operand"):
        tlinalg.cg(torch.eye(32), b, refine="auto")


# ------------------------------------------- f32acc and sliced-ELL ops


def _ops_inputs(seed=21):
    S = random_csr(96, 80, density=0.1, seed=seed)
    Aj, At = pair(S)
    Cj, Ct = Aj.compress(), At.compress()
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(80).astype(np.float32)
    X = rng.standard_normal((80, 4)).astype(np.float32)
    return Cj, Ct, x, X


def test_csr_rowids_f32acc_ops_bitwise():
    Cj, Ct, x, X = _ops_inputs()
    rid_t, rid_j = Ct._get_row_ids(), Cj._get_row_ids()
    yt = tspmv.csr_spmv_rowids_f32acc(Ct.data, Ct.indices, rid_t,
                                      torch.from_numpy(x), 96)
    yj = jspmv.csr_spmv_rowids_f32acc(Cj.data, Cj.indices, rid_j,
                                      jnp.asarray(x), 96)
    assert yt.dtype == torch.float32
    np.testing.assert_array_equal(yt.numpy(), np.asarray(yj))
    Yt = tspmv.csr_spmm_rowids_f32acc(Ct.data, Ct.indices, rid_t,
                                      torch.from_numpy(X), 96)
    Yj = jspmv.csr_spmm_rowids_f32acc(Cj.data, Cj.indices, rid_j,
                                      jnp.asarray(X), 96)
    np.testing.assert_array_equal(Yt.numpy(), np.asarray(Yj))
    # bf16 operand: bf16 out, f32 accumulation.
    xb = torch.from_numpy(x).to(torch.bfloat16)
    yb = tspmv.csr_spmv_rowids_f32acc(Ct.data, Ct.indices, rid_t, xb, 96)
    ybj = jspmv.csr_spmv_rowids_f32acc(Cj.data, Cj.indices, rid_j,
                                       jnp.asarray(x, jnp.bfloat16), 96)
    assert yb.dtype == torch.bfloat16
    assert np.array_equal(bits(yb), bits(ybj))


def test_csr_rowids_masked_f32acc_bitwise():
    """A zero-padded suffix: slots at or past ``valid_nnz`` give an
    exact 0 even against inf, the padded row id ``rows`` is dropped."""
    Cj, Ct, x, _ = _ops_inputs(22)
    nnz, pad = Ct.nnz, 7
    data = torch.cat([Ct.data, torch.ones(pad, dtype=torch.bfloat16)])
    idx = torch.cat([Ct.indices, torch.zeros(pad, dtype=torch.int16)])
    rid = torch.cat([Ct._get_row_ids(),
                     torch.full((pad,), 96, dtype=torch.int64)])
    xi = x.copy()
    xi[0] = np.inf
    got = tspmv.csr_spmv_rowids_masked_f32acc(data, idx, rid, nnz,
                                              torch.from_numpy(xi), 96)
    want = jspmv.csr_spmv_rowids_masked_f32acc(
        jnp.asarray(bits(data)).view(jnp.bfloat16), jnp.asarray(idx.numpy()),
        jnp.asarray(rid.numpy()), nnz, jnp.asarray(xi), 96)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_ell_spmv_f32acc_bitwise():
    Cj, Ct, x, _ = _ops_inputs(23)
    ell_t, ell_j = Ct._get_ell(), Cj._get_ell()
    assert ell_t[1].dtype == torch.int16
    yt = tspmv.ell_spmv_f32acc(*ell_t, torch.from_numpy(x))
    yj = jspmv.ell_spmv_f32acc(*ell_j, jnp.asarray(x))
    np.testing.assert_array_equal(yt.numpy(), np.asarray(yj))


def test_sliced_ell_pack_and_spmv_bitwise():
    """A skewed matrix (one dense row) that flat ELL declines: the bins
    equal the JAX package's bit for bit, and the SpMVs agree at 1e-6
    relative: XLA sums the dense row's 256-wide bin in another order
    than its narrow ones (the port sums every row in slot order)."""
    S = random_csr(200, density=0.03, seed=24).tolil()
    S[3, :] = np.linspace(0.1, 2.0, 200).astype(np.float32)
    S[7, :] = 0.0
    S = sp.csr_array(S.tocsr())
    Aj, At = pair(S)
    assert At._get_ell() is None
    bins_t, bins_j = At._get_sliced_ell(), Aj._get_sliced_ell()
    assert len(bins_t) == len(bins_j)
    for bt, bj in zip(bins_t, bins_j):
        for a, b_ in zip(bt, bj):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b_))
    x = np.linspace(-1.0, 1.0, 200).astype(np.float32)
    yt = tspmv.sliced_ell_spmv(bins_t, torch.from_numpy(x), 200)
    yj = jspmv.sliced_ell_spmv(bins_j, jnp.asarray(x), 200)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=1e-6,
                               atol=0)
    narrow = np.ones(200, bool)
    narrow[3] = False
    np.testing.assert_array_equal(yt.numpy()[narrow], np.asarray(yj)[narrow])
    np.testing.assert_allclose(yt.numpy(), S @ x, rtol=1e-5, atol=1e-5)
    assert yt[7] == 0
    Ct, Cj = At.compress(), Aj.compress()
    bt, bj = Ct._get_sliced_ell(), Cj._get_sliced_ell()
    yt = tspmv.sliced_ell_spmv_f32acc(bt, torch.from_numpy(x), 200)
    yj = jspmv.sliced_ell_spmv_f32acc(bj, jnp.asarray(x), 200)
    assert yt.dtype == torch.float32
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=1e-6,
                               atol=0)
    np.testing.assert_array_equal(yt.numpy()[narrow], np.asarray(yj)[narrow])
    nbytes = Ct.spmv_traffic_bytes(torch.from_numpy(x), path="sliced-ell")
    assert nbytes > Ct.nnz * 4


# --------------------------------------- the facade on int16 indices


def _int16_pair(seed=30):
    S = random_csr(70, 90, density=0.08, seed=seed)
    Aj, At = pair(S)
    Cj, Ct = Aj.compress(), At.compress()
    assert Ct.indices.dtype == torch.int16
    return Cj, Ct


def same_csr(Mj, Mt):
    assert tuple(Mj.shape) == tuple(Mt.shape)
    dj = np.asarray(Mj.data)
    if str(dj.dtype) == "bfloat16":
        assert np.array_equal(bits(Mt.data), bits(dj))
    else:
        np.testing.assert_array_equal(host(Mt.data), dj)
    assert np.dtype(Mj.indices.dtype).itemsize == Mt.indices.element_size()
    np.testing.assert_array_equal(Mt.indices.numpy().astype(np.int64),
                                  np.asarray(Mj.indices).astype(np.int64))
    np.testing.assert_array_equal(Mt.indptr.numpy().astype(np.int64),
                                  np.asarray(Mj.indptr).astype(np.int64))


@pytest.mark.parametrize("op", ["T", "tocsc_tocsr", "rows", "cols",
                                "cols_array", "esc", "add", "multiply",
                                "scalar"])
def test_int16_facade_ops_bitwise(op):
    Cj, Ct = _int16_pair()
    if op == "T":
        Mj, Mt = Cj.T, Ct.T
    elif op == "tocsc_tocsr":
        Mj, Mt = Cj.tocsc().tocsr(), Ct.tocsc().tocsr()
    elif op == "rows":
        Mj, Mt = Cj[[5, 0, 5, 69]], Ct[[5, 0, 5, 69]]
    elif op == "cols":
        Mj, Mt = Cj[:, 10:40], Ct[:, 10:40]
    elif op == "cols_array":
        Mj, Mt = Cj[:, [3, 80, 3]], Ct[:, [3, 80, 3]]
    elif op == "esc":
        Bj, Bt = _int16_pair(31)
        Mj, Mt = Cj @ Bj.T, Ct @ Bt.T
        assert Ct.spgemm_path == "esc"
    elif op == "add":
        Mj, Mt = Cj + Cj, Ct + Ct
    elif op == "multiply":
        D = np.linspace(-1.0, 1.0, 70 * 90).reshape(70, 90).astype(np.float32)
        Mj, Mt = Cj.multiply(jnp.asarray(D)), Ct.multiply(torch.from_numpy(D))
    else:
        Mj, Mt = Cj * 3.0, Ct * 3.0
    same_csr(Mj, Mt)


def test_int16_tocoo_todia_and_reductions():
    Cj, Ct = _int16_pair(32)
    Oj, Ot = Cj.tocoo(), Ct.tocoo()
    for a, b_ in ((Ot.row, Oj.row), (Ot.col, Oj.col)):
        np.testing.assert_array_equal(np.asarray(a).astype(np.int64),
                                      np.asarray(b_).astype(np.int64))
    assert np.array_equal(bits(Ot.data), bits(Oj.data))
    np.testing.assert_array_equal(host(Ct.todense()),
                                  np.asarray(Cj.todense()).astype(np.float32))
    np.testing.assert_array_equal(host(Ct.diagonal(2)),
                                  np.asarray(Cj.diagonal(2)).astype(
                                      np.float32))
    assert Ct[4, int(Ct.indices[int(Ct.indptr[4])])] == \
        Cj[4, int(Cj.indices[int(Cj.indptr[4])])]
    B = tsparse.diags([np.ones(100), np.ones(99)], [0, 1], shape=(100, 100),
                      format="csr", dtype=np.float32, device="cpu").compress()
    assert B.indices.dtype == torch.int16
    D = B.todia()
    assert tuple(D.offsets.tolist()) == (0, 1)
    x = torch.linspace(-1.0, 1.0, 100)
    np.testing.assert_array_equal((B @ x).numpy(),
                                  (B.astype_storage(indices="int32")
                                   @ x).numpy())


def test_int16_columns_with_more_rows_than_int16():
    """A tall matrix whose 64 columns take int16 indices while its
    40,000 rows do not fit int16: its transpose, COO view, sum and
    product keep every row (against scipy; the JAX package casts the
    row ids to int16 there and wraps them, ROADMAP queue 3 item 11)."""
    rng = np.random.default_rng(33)
    S = sp.random(40_000, 64, density=0.02, random_state=rng, format="csr",
                  dtype=np.float32)
    Ct = tsparse.csr_array(S, device="cpu").compress()
    assert Ct.indices.dtype == torch.int16
    Sr = sp.csr_matrix((host(Ct.data), Ct.indices.numpy(),
                        Ct.indptr.numpy()), shape=S.shape)
    T = Ct.T
    assert T.shape == (64, 40_000) and T.indices.dtype == torch.int32
    np.testing.assert_array_equal(host(T.todense()), Sr.T.toarray())
    O = Ct.tocoo()
    assert int(O.row.max()) == Sr.tocoo().row.max()
    np.testing.assert_array_equal(host((Ct + Ct).todense()),
                                  (Sr + Sr).toarray())
    x = np.linspace(-1.0, 1.0, 40_000).astype(np.float32)
    np.testing.assert_allclose((T @ torch.from_numpy(x)).numpy(),
                               Sr.T @ x, rtol=1e-4, atol=1e-4)
