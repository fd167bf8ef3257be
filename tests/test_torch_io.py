# Copyright 2026.
# SPDX-License-Identifier: Apache-2.0
"""The port's Matrix Market and npz io, its namespace and its scipy
fallbacks, against the JAX package's and scipy's, on the CPU.

Mirrors ``test_io.py``, ``test_scipy_fallbacks.py`` and the io half of
``test_gallery_io_extras.py``.  Every file is written here, from a
seed.  Both parser tiers run: the numpy parser, and the native one
(``src/mtx_reader.cc``, built with the host C++ compiler into
``build/native/``).

Tolerances: none.  A file read back must give the same matrix bit for
bit: the same shape, and after sorting each row (the tiers order a
symmetric file's mirrored entries differently) the same indices and
values; a file written must be the JAX package's text byte for byte;
an npz round trip must give back the same arrays, bf16 values
included.
"""

import io as pyio

import numpy as np
import pytest
import scipy.io
import scipy.sparse as sp
import torch

import legate_sparse_tpu as jsparse

import legate_sparse_tpu_torch as tsparse
from legate_sparse_tpu_torch import io as tio
from legate_sparse_tpu_torch import linalg as tlinalg
from legate_sparse_tpu_torch import runtime, utils_native

MTX = {
    "real-general": ("%%MatrixMarket matrix coordinate real general\n"
                     "% a comment\n"
                     "3 4 4\n1 2 1.5\n2 2 -2.0\n3 1 0.25\n3 4 1e-3\n"),
    "integer-general": ("%%MatrixMarket matrix coordinate integer general\n"
                        "2 2 2\n1 1 3\n2 2 -7\n"),
    "pattern-general": ("%%MatrixMarket matrix coordinate pattern general\n"
                        "3 4 3\n1 1\n2 3\n3 4\n"),
    "real-symmetric": ("%%MatrixMarket matrix coordinate real symmetric\n"
                       "3 3 4\n1 1 2.0\n2 1 -1.0\n3 1 0.5\n3 3 4.0\n"),
    "pattern-symmetric": ("%%MatrixMarket matrix coordinate pattern "
                          "symmetric\n3 3 3\n1 1\n3 1\n3 2\n"),
    "real-skew-symmetric": ("%%MatrixMarket matrix coordinate real "
                            "skew-symmetric\n3 3 2\n2 1 5.0\n3 2 -1.5\n"),
    "integer-skew-symmetric": ("%%MatrixMarket matrix coordinate integer "
                               "skew-symmetric\n3 3 2\n2 1 5\n3 1 -2\n"),
}


@pytest.fixture(autouse=True)
def _cpu():
    runtime.set_device("cpu")
    yield
    runtime.set_device(None)


@pytest.fixture(scope="module")
def native_lib():
    """The native parser, built once for this module."""
    utils_native.build()
    yield
    utils_native.reload()


@pytest.fixture(params=["numpy", "native"])
def tier(request, monkeypatch):
    if request.param == "native":
        request.getfixturevalue("native_lib")
        assert utils_native.reload()
    else:
        monkeypatch.setattr(utils_native, "_load", lambda: None)
    return request.param


@pytest.mark.parametrize("mode", ["off", "builds", "compile-fails"])
def test_opt_in_build_at_first_use(tmp_path, monkeypatch, capsys, mode):
    """``LEGATE_SPARSE_TPU_BUILD_NATIVE=1`` builds the parser at its
    first use; a failed build leaves the numpy parser and says so on
    stderr; unset, nothing is built.  The read is scipy's either way."""
    if mode != "off":
        monkeypatch.setenv("LEGATE_SPARSE_TPU_BUILD_NATIVE", "1")
    else:
        monkeypatch.delenv("LEGATE_SPARSE_TPU_BUILD_NATIVE", raising=False)
    if mode == "compile-fails":
        monkeypatch.setenv("CXX", "false")
    lib = tmp_path / "native" / "liblst_mtx_reader.so"
    monkeypatch.setattr(utils_native, "LIBRARY", str(lib))
    monkeypatch.setattr(utils_native, "_LIB", None)
    monkeypatch.setattr(utils_native, "_LIB_TRIED", False)
    text = MTX["real-symmetric"]
    path = tmp_path / "a.mtx"
    path.write_text(text)
    A = tio.mmread(str(path))
    built = mode == "builds"
    assert utils_native._LIB_TRIED
    assert (utils_native._LIB is not None) == built
    assert lib.exists() == built
    assert (utils_native.native_mtx_read(str(path)) is not None) == built
    err = capsys.readouterr().err
    assert ("using the numpy parser" in err) == (mode == "compile-fails")
    want = scipy.io.mmread(pyio.StringIO(text)).toarray()
    np.testing.assert_array_equal(A.toscipy().toarray(), want)


def sorted_parts(A):
    """(shape, indptr, indices, values) of a CSR matrix with each row
    sorted, as numpy arrays (``A`` of either package, or scipy)."""
    if not sp.issparse(A):
        A = sp.csr_array((np.asarray(A.data), np.asarray(A.indices),
                          np.asarray(A.indptr)), shape=A.shape)
    A = sp.csr_array(A, copy=True)
    A.sort_indices()
    return A.shape, A.indptr, A.indices, A.data


def same(P, Q):
    for p, q in zip(sorted_parts(P), sorted_parts(Q)):
        np.testing.assert_array_equal(np.asarray(p), np.asarray(q))


@pytest.mark.parametrize("name", sorted(MTX))
def test_mmread_formats_and_symmetries(tmp_path, tier, name):
    path = tmp_path / f"{name}.mtx"
    path.write_text(MTX[name])
    At = tsparse.mmread(path)
    assert isinstance(At, tsparse.csr_array) and At.dtype == torch.float64
    assert At.device.type == "cpu"
    same(At.toscipy(), jsparse.mmread(str(path)))
    same(At.toscipy(), sp.csr_array(scipy.io.mmread(str(path))))


def test_parser_tiers_equal(tmp_path, native_lib):
    """The two tiers parse the same entries; a symmetric file's mirrored
    entries come in another order (the native tier puts each right
    after its original)."""
    assert utils_native.reload()
    for name, text in MTX.items():
        path = tmp_path / f"{name}.mtx"
        path.write_text(text)
        native = utils_native.native_mtx_read(str(path))
        host = tio._parse_mtx_host(str(path))
        assert native is not None and native[:2] == host[:2], name
        for parts in (native, host):
            assert [a.dtype for a in parts[2:]] == [np.int64, np.int64,
                                                    np.float64]
        order_n = np.lexsort((native[3], native[2]))
        order_h = np.lexsort((host[3], host[2]))
        for a, b in zip(native[2:], host[2:]):
            np.testing.assert_array_equal(a[order_n], b[order_h])
    # A file the native parser refuses (truncated) goes to numpy, which
    # raises on it.
    bad = tmp_path / "bad.mtx"
    bad.write_text("%%MatrixMarket matrix coordinate real general\n"
                   "3 3 3\n1 1 1.0\n")
    assert utils_native.native_mtx_read(str(bad)) is None


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_mmwrite_text_and_round_trip(tmp_path, tier, dtype):
    rng = np.random.default_rng(2)
    S = sp.csr_array(sp.random(17, 13, density=0.3, format="csr",
                               random_state=rng).astype(dtype))
    pt, pj = tmp_path / "t.mtx", tmp_path / "j.mtx"
    tio.mmwrite(pt, tsparse.csr_array(S, device="cpu"))
    jsparse.mmwrite(str(pj), jsparse.csr_array(S))
    assert pt.read_text() == pj.read_text()
    back = tsparse.mmread(pt)
    same(back.toscipy(), S.astype(np.float64))
    assert torch.equal(back.astype(dtype).data,
                       tsparse.csr_array(S, device="cpu").data)


def test_mmwrite_rejects_complex(tmp_path):
    C = tsparse.csr_array(sp.csr_array(np.array([[1j, 0], [0, 2]])),
                          device="cpu")
    with pytest.raises(TypeError):
        tio.mmwrite(tmp_path / "c.mtx", C)


def test_mmread_unsupported_raises(tmp_path):
    path = tmp_path / "arr.mtx"
    path.write_text("%%MatrixMarket matrix array real general\n2 2\n1\n2\n"
                    "3\n4\n")
    with pytest.raises(NotImplementedError):
        tsparse.mmread(path)
    path.write_text("not a matrix market file\n")
    with pytest.raises(ValueError):
        tsparse.mmread(path)


# ------------------------------------------------------------------ npz


@pytest.mark.parametrize("compressed", [True, False])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_npz_round_trip(compressed, dtype):
    rng = np.random.default_rng(3)
    S = sp.csr_array(sp.random(30, 20, density=0.2, format="csr",
                               random_state=rng).astype(dtype))
    A = tsparse.csr_array(S, device="cpu")
    buf = pyio.BytesIO()
    tsparse.save_npz(buf, A, compressed=compressed)
    buf.seek(0)
    back = tsparse.load_npz(buf)
    for p, q in ((back.data, A.data), (back.indices, A.indices),
                 (back.indptr, A.indptr)):
        assert torch.equal(p, q)
    buf.seek(0)
    same(sp.load_npz(buf), S)               # scipy reads the container
    buf = pyio.BytesIO()
    jsparse.save_npz(buf, jsparse.csr_array(S), compressed=compressed)
    buf.seek(0)
    same(tsparse.load_npz(buf).toscipy(), S)  # and the JAX package's


def test_npz_bf16_bit_for_bit_both_ways():
    import jax.numpy as jnp

    vals = np.array([1.0, -2.5, 3.140625, 1e-3, 7.0], dtype=np.float32)
    rows, cols = np.array([0, 0, 1, 2, 2]), np.array([0, 2, 1, 0, 2])
    At = tsparse.csr_array((vals, (rows, cols)), shape=(3, 3),
                           dtype=torch.bfloat16, device="cpu")
    Aj = jsparse.csr_array((vals, (rows, cols)), shape=(3, 3),
                           dtype=jnp.bfloat16)
    bits_t = At.data.view(torch.int16).numpy()
    bits_j = np.asarray(Aj.data).view(np.int16)
    np.testing.assert_array_equal(bits_t, bits_j)
    for save, load in ((tsparse.save_npz, tsparse.load_npz),
                       (tsparse.save_npz, jsparse.load_npz),
                       (jsparse.save_npz, tsparse.load_npz)):
        buf = pyio.BytesIO()
        save(buf, At if save is tsparse.save_npz else Aj)
        buf.seek(0)
        back = load(buf)
        assert str(back.dtype).endswith("bfloat16")
        data = (back.data.view(torch.int16).numpy()
                if isinstance(back, tsparse.csr_array)
                else np.asarray(back.data).view(np.int16))
        np.testing.assert_array_equal(data, bits_t)
    buf = pyio.BytesIO()
    tsparse.save_npz(buf, At)
    buf.seek(0)
    assert sp.load_npz(buf).dtype == np.uint16    # scipy: the raw patterns


@pytest.mark.parametrize("fmt", ["csc", "coo", "dia"])
def test_load_npz_other_containers(fmt):
    S = sp.csr_array(sp.diags([np.arange(1.0, 6.0), np.ones(4)], [0, 1]))
    buf = pyio.BytesIO()
    sp.save_npz(buf, S.asformat(fmt))
    buf.seek(0)
    same(tsparse.load_npz(buf).toscipy(), S)


def test_save_npz_of_other_formats():
    buf = pyio.BytesIO()
    tsparse.save_npz(buf, tsparse.eye(4, device="cpu"))   # a dia_array
    buf.seek(0)
    np.testing.assert_array_equal(sp.load_npz(buf).toarray(), np.eye(4))


# ------------------------------------------------------------ namespace


def test_predicates_match_the_jax_package():
    S = sp.csr_array(np.eye(3))
    objs_t = [tsparse.csr_array(S, device="cpu"),
              tsparse.coo_array(S, device="cpu"),
              tsparse.csc_array(S, device="cpu"),
              tsparse.dia_array((np.ones((1, 3)), [0]), shape=(3, 3),
                                device="cpu"),
              S, np.eye(3)]
    objs_j = [jsparse.csr_array(S), jsparse.coo_array(S),
              jsparse.csc_array(S),
              jsparse.dia_array((np.ones((1, 3)), [0]), shape=(3, 3)),
              S, np.eye(3)]
    for name in ("issparse", "isspmatrix", "is_sparse_matrix",
                 "isspmatrix_coo", "isspmatrix_csc", "isspmatrix_csr",
                 "isspmatrix_dia"):
        got = [getattr(tsparse, name)(o) for o in objs_t]
        want = [bool(getattr(jsparse, name)(o)) for o in objs_j]
        assert got == want, name
    assert tsparse.coord_ty == torch.int32 and tsparse.nnz_ty == torch.int64


def test_clone_scipy_arr_kind_matches_the_jax_package():
    from legate_sparse_tpu import coverage as jcov
    from legate_sparse_tpu_torch import coverage as tcov

    def stamped(cov, doc):
        cls = type("Kind", (), {"__doc__": doc})
        return cov.clone_scipy_arr_kind(sp.csr_array)(cls)

    for doc in (None, "own doc"):
        got, want = stamped(tcov, doc), stamped(jcov, doc)
        assert got._scipy_origin is want._scipy_origin is sp.csr_array
        assert got.__doc__ == want.__doc__
        assert got.__doc__ == (doc or sp.csr_array.__doc__)


def test_spmv_fills_y():
    A = tsparse.diags([1.0, -2.0, 1.0], [-1, 0, 1], shape=(6, 6),
                      format="csr", device="cpu")
    x = torch.arange(6, dtype=torch.float64)
    y = torch.empty(6, dtype=torch.float64)
    assert tsparse.spmv(A, x, y) is y
    assert torch.equal(y, A @ x)


def test_linalg_fallbacks_return_port_objects():
    A = tsparse.diags([1.0, -2.0, 1.0], [-1, 0, 1], shape=(16, 16),
                      format="csr", device="cpu")
    S = sp.diags([1.0, -2.0, 1.0], [-1, 0, 1], shape=(16, 16)).tocsr()
    b = torch.ones(16, dtype=torch.float64)
    x = tlinalg.spsolve(A, b)
    assert isinstance(x, torch.Tensor) and x.device.type == "cpu"
    assert np.linalg.norm(S @ x.numpy() - 1.0) < 1e-10
    assert getattr(tlinalg.spsolve, "_lst_scipy_fallback", False)
    assert tlinalg.spsolve is tlinalg.spsolve          # cached, one wrapper
    E = tlinalg.expm(A.tocsc())
    assert isinstance(E, tsparse.csc_array)
    np.testing.assert_allclose(E.toscipy().toarray(),
                               sp.linalg.expm(S.tocsc()).toarray(),
                               rtol=1e-9, atol=1e-12)
    with pytest.raises(AttributeError):
        tlinalg.definitely_not_a_solver  # noqa: B018
    assert not hasattr(tlinalg, "__path__")   # scipy's internals stay its own


def test_toplevel_fallbacks_and_native_names():
    import inspect

    R = tsparse.random_array((8, 6), density=0.5,
                             rng=np.random.default_rng(0))
    assert getattr(tsparse.random_array, "_lst_scipy_fallback", False)
    assert isinstance(R, tsparse.coo_array) and R.shape == (8, 6)
    D = tsparse.diags_array([1.0, 2.0], offsets=[0, 1], shape=(3, 3))
    assert isinstance(D, tsparse.dia_array) and D.device.type == "cpu"
    for fn in (tsparse.kron, tsparse.tril, tsparse.save_npz,
               tsparse.load_npz, tsparse.mmread, tsparse.issparse):
        mod = inspect.getmodule(inspect.unwrap(fn)).__name__
        assert mod.startswith("legate_sparse_tpu_torch"), (fn, mod)
        assert not getattr(fn, "_lst_scipy_fallback", False)
    assert tsparse.linalg.__name__ == "legate_sparse_tpu_torch.linalg"


@pytest.mark.parametrize("name", ["eigs", "eigsh", "lobpcg", "svds"])
def test_unported_eigen_names_raise(name):
    """(Named when these raised, before ``eigen.py`` was ported.)  Each
    name is the port's own function, not a scipy fallback, and answers
    on the operator's device."""
    import inspect

    A = tsparse.diags([1.0, -2.0, 1.0], [-1, 0, 1], shape=(16, 16),
                      format="csr", device="cpu")
    fn = getattr(tlinalg, name)
    assert inspect.getmodule(fn).__name__ == "legate_sparse_tpu_torch.eigen"
    assert not getattr(fn, "_lst_scipy_fallback", False)
    assert getattr(tsparse.linalg, name) is fn
    if name == "lobpcg":
        out = fn(A, np.random.default_rng(0).standard_normal((16, 3)))
    else:
        out = fn(A, k=3)
    w = out[1] if name == "svds" else out[0]
    assert isinstance(w, torch.Tensor) and w.device.type == "cpu"


def test_csgraph_raises_instead_of_scipys_module():
    """(Named when ``csgraph`` raised, before ``csgraph.py`` was
    ported.)  The name is the port's own module, not scipy's, and
    unknown names still raise."""
    from legate_sparse_tpu_torch import csgraph

    assert tsparse.csgraph is csgraph
    assert csgraph.__name__ == "legate_sparse_tpu_torch.csgraph"
    assert not getattr(csgraph.dijkstra, "_lst_scipy_fallback", False)
    with pytest.raises(AttributeError):
        tsparse.definitely_not_a_name  # noqa: B018


def test_fallback_results_follow_their_inputs_device(monkeypatch):
    """A fallback's result goes to its sparse input's device; with no
    such input, to the default device (which raises with no CUDA device
    and no request for the CPU)."""
    S = sp.csr_array(sp.eye(4))
    A = tsparse.csr_array(S, device="cpu")
    runtime.set_device(None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    E = tlinalg.expm(A.tocsc())
    assert E.device.type == "cpu"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsparse.random_array((4, 4), density=0.5)
