# Copyright 2026.
# SPDX-License-Identifier: Apache-2.0
"""The port's public surface holds the JAX package's: every public name
a JAX module defines at its top level (or its package ``__init__``
exports), and every public attribute of the classes it defines, exists
in the port's module of the same dotted name, save the decided
exclusions of ``EXCLUDED``.

Each exclusion names its reason and the ROADMAP item that decided it,
and ``test_exclusion_is_live`` holds that it is still missing from the
port (a name that comes back leaves the table).  The value cases hold
the names the parity walk added against the JAX package on the same
inputs: ``dim``, ``make_with_same_nnz_structure``, ``shard_row_starts``,
``factor_int``, the ``types`` aliases and ``autotune_enabled`` exactly,
the plain ``ops`` functions and aliases bit for bit (f64), and the
port's plain BSR product against the JAX ``bsr_spmv_xla`` that it stands
for (f32 einsum, 1e-6 relative); ``Runtime`` is held to the port's own
device policy on the CPU.
"""

import ast
import importlib
import inspect
import pathlib
from types import SimpleNamespace

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import legate_sparse_tpu as jsparse
from legate_sparse_tpu.settings import settings as jsettings

import legate_sparse_tpu_torch as tsparse
from legate_sparse_tpu_torch import runtime
from legate_sparse_tpu_torch.settings import settings as tsettings

ROOT = pathlib.Path(__file__).resolve().parents[1]
JAX_PKG = ROOT / "legate_sparse_tpu"

# JAX name (dotted, module-qualified) -> (reason, ROADMAP item).
EXCLUDED = {
    "legate_sparse_tpu._platform": (
        "pins JAX to the host platform; the port's runtime device policy "
        "does that job", "queue 1, not planned for a port"),
    "legate_sparse_tpu.parallel._compat": (
        "a jax.shard_map shim", "queue 1, not planned for a port"),
    "legate_sparse_tpu.ops.pallas_dia": (
        "the three Pallas DIA kernels; their ports are ops/dia_kernel.py "
        "and csrc/dia_{spmv,spmm,spgemm}.cu", "queue 2, items 1, 3 and 5"),
    "legate_sparse_tpu.ops.bsr.bsr_spmv_pallas": (
        "a Pallas kernel; its port is bsr.bsr_spmv over csrc/bsr_spmv.cu",
        "queue 2, item 2"),
    "legate_sparse_tpu.ops.bsr.bsr_spmm_pallas": (
        "a Pallas kernel; its port is bsr.bsr_spmm over csrc/bsr_spmm.cu",
        "queue 2, item 4"),
    "legate_sparse_tpu.ops.bsr.bsr_pack": (
        "densifies the present blocks for Mosaic; the port's structure "
        "is the block list built on the device (build_structure)",
        "queue 2, item 2"),
    "legate_sparse_tpu.ops.dia_ops.dia_spmv_fused": (
        "an XLA format of the JAX banded route; the port's is the DIA "
        "kernel", "queue 1, not planned for a port"),
    "legate_sparse_tpu.ops.dia_ops.dia_spmm_fused": (
        "an XLA format of the JAX banded route; the port's is the DIA "
        "kernel", "queue 1, not planned for a port"),
    "legate_sparse_tpu.ops.dia_ops.pad_dia": (
        "the padding of the fused XLA format", "queue 1, not planned for "
        "a port"),
    "legate_sparse_tpu.ops.dia_ops.dia_spmv_masked": (
        "the masked XLA form; the port's is dia_spmv_nopad(mask=)",
        "queue 3, item 20"),
    "legate_sparse_tpu.linalg.maybe_jit": (
        "wraps a solver loop in jax.jit; the port's loops run eagerly",
        "queue 3, item 20"),
    "legate_sparse_tpu.engine.maybe_enable_persistent_cache": (
        "JAX's persistent compile cache; a plan here compiles nothing",
        "queue 3, item 15"),
    "legate_sparse_tpu.engine.plan_cache.maybe_enable_persistent_cache": (
        "JAX's persistent compile cache; a plan here compiles nothing",
        "queue 3, item 15"),
    "legate_sparse_tpu.engine.plan_cache.lower_plan": (
        "lowers a plan through XLA; a plan here is an eager function",
        "queue 3, item 15"),
    "legate_sparse_tpu.engine.plan_cache.plan_program": (
        "a plan's ShapeDtypeStruct program; a plan here is an eager "
        "function", "queue 3, item 15"),
    "legate_sparse_tpu.engine.plan_cache.Plan.compiled": (
        "the XLA executable of a plan", "queue 3, item 20"),
    "legate_sparse_tpu.engine.plan_cache.Plan.traced": (
        "the jax trace of a plan", "queue 3, item 20"),
    "legate_sparse_tpu.parallel.dist_csr.DIST_PLAN_SHAPES": (
        "the planverify catalog of distributed programs, JAX tooling",
        "queue 1, item 9"),
    "legate_sparse_tpu.parallel.dist_spgemm.SPGEMM_PLAN_SHAPES": (
        "the planverify catalog of SpGEMM programs, JAX tooling",
        "queue 3, item 20"),
    "legate_sparse_tpu.utils_native.native_available": (
        "the native BSR pack and COO-to-CSR helpers' probe; the port "
        "builds both on the matrix's device", "queue 1, items 3-7"),
    "legate_sparse_tpu.utils_native.native_bsr_pack": (
        "the port builds its BSR structure on the matrix's device",
        "queue 1, items 3-7"),
    "legate_sparse_tpu.utils_native.native_coo_to_csr": (
        "the port builds its CSR on the matrix's device",
        "queue 1, items 3-7"),
}
# The internal steps of the JAX package's XLA routes: each is a piece of
# a JAX function whose port does the whole job in one (queue 3, item 20).
for _name, _reason in (
        ("ops.spgemm.sort_coo", "a step of the JAX coalesce_coo; the "
         "port's coalesce_coo sorts on one key"),
        ("ops.spgemm.run_heads", "a step of the JAX coalesce_coo"),
        ("ops.spgemm.compress_coo", "a step of the JAX coalesce_coo"),
        ("ops.convert.dense_nnz", "a step of the JAX csr_array's dense "
         "constructor; the port's dense_to_csr counts its nonzeros"),
        ("ops.spmv.csr_rmatvec", "called by nothing in the JAX package; "
         "A.T @ x goes through the transpose in both"),
        ("ops.bsr.bsr_spmv_xla", "the JAX XLA route over densified "
         "blocks; the port's plain BSR product is bsr_spmv_plain over "
         "the block list")):
    EXCLUDED[f"legate_sparse_tpu.{_name}"] = (
        f"internal step of the JAX XLA route, no user path: {_reason}",
        "queue 3, item 20")
# DistCSR's global-array layouts: an SPMD rank holds its own blocks
# (queue 3, item 12), so the JAX controller's stacked DIA and BSR
# arrays have no attribute here.
for _attr in ("pdia_data", "pdia_mask", "pdia_tile", "bsr_bcol",
              "bsr_blocks", "bsr_brow", "bsr_grid"):
    EXCLUDED[f"legate_sparse_tpu.parallel.dist_csr.DistCSR.{_attr}"] = (
        "a stacked global layout of the JAX controller; each rank holds "
        "its own blocks", "queue 3, item 12")


def _module_names():
    out = []
    for path in sorted(JAX_PKG.rglob("*.py")):
        parts = path.relative_to(ROOT).with_suffix("").parts
        if parts[-1] == "__init__":
            parts = parts[:-1]
        out.append(".".join(parts))
    return out


MODULES = _module_names()


def _port_name(name: str) -> str:
    return "legate_sparse_tpu_torch" + name[len("legate_sparse_tpu"):]


def _defined(jmod) -> set:
    """Public names a module's top-level statements bind, and the public
    non-module names its package namespace exports."""
    path = pathlib.Path(jmod.__file__)
    names = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names.update(t.id for t in node.targets
                         if isinstance(t, ast.Name))
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target,
                                                            ast.Name):
            names.add(node.target.id)
    if path.name == "__init__.py":
        names.update(n for n, v in vars(jmod).items()
                     if not inspect.ismodule(v))
    return {n for n in names if not n.startswith("_")}


def _missing(name: str) -> list:
    """The JAX module's public names (and its classes' public
    attributes) that the port's module lacks, dotted."""
    jmod = importlib.import_module(name)
    try:
        tmod = importlib.import_module(_port_name(name))
    except ModuleNotFoundError:
        return [name]
    out = []
    for n in sorted(_defined(jmod)):
        if not hasattr(tmod, n):
            out.append(f"{name}.{n}")
            continue
        jobj = getattr(jmod, n)
        if inspect.isclass(jobj) and jobj.__module__ == name:
            tobj = getattr(tmod, n)
            out += [f"{name}.{n}.{a}" for a in dir(jobj)
                    if not a.startswith("_") and not hasattr(tobj, a)]
    return out


@pytest.mark.parametrize("name", MODULES)
def test_port_has_every_public_name(name):
    missing = [m for m in _missing(name) if m not in EXCLUDED]
    assert not missing, f"the port lacks {missing}"


@pytest.mark.parametrize("name", sorted(EXCLUDED))
def test_exclusion_is_live(name):
    reason, item = EXCLUDED[name]
    assert reason and item.startswith("queue ")
    mod = next(m for m in sorted(MODULES, key=len, reverse=True)
               if name == m or name.startswith(m + "."))
    assert name in _missing(mod), f"{name} is in the port: drop it here"


def test_excluded_table_is_the_decided_list():
    """The table holds the decided exclusions and nothing else."""
    assert {n.rsplit(".", 1)[-1] for n in EXCLUDED} == {
        "_platform", "_compat", "pallas_dia", "bsr_spmv_pallas",
        "bsr_spmm_pallas", "bsr_pack", "dia_spmv_fused", "dia_spmm_fused",
        "pad_dia", "dia_spmv_masked", "maybe_jit",
        "maybe_enable_persistent_cache", "lower_plan", "plan_program",
        "compiled", "traced", "DIST_PLAN_SHAPES", "SPGEMM_PLAN_SHAPES",
        "native_available", "native_bsr_pack", "native_coo_to_csr",
        "pdia_data", "pdia_mask", "pdia_tile", "bsr_bcol", "bsr_blocks",
        "bsr_brow", "bsr_grid", "sort_coo", "run_heads", "compress_coo",
        "dense_nnz", "csr_rmatvec", "bsr_spmv_xla"}


# ---- values against the JAX package ----------------------------------
def _scipy_csr(seed=3, shape=(9, 7)):
    return sp.random(*shape, density=0.3, format="csr",
                     random_state=np.random.default_rng(seed))


@pytest.mark.parametrize("fmt", ["csr_array", "coo_array", "csc_array",
                                 "csr_matrix"])
def test_dim(fmt):
    S = _scipy_csr()
    J = getattr(jsparse, fmt)(S)
    T = getattr(tsparse, fmt)(S, device="cpu")
    assert T.dim == J.dim == 2


def test_make_with_same_nnz_structure():
    S = _scipy_csr()
    new_data = np.arange(1.0, S.nnz + 1.0)
    arg = (new_data, S.indices, S.indptr)
    J = jsparse.csr_array.make_with_same_nnz_structure(
        jsparse.csr_array(S), arg)
    T = tsparse.csr_array.make_with_same_nnz_structure(
        tsparse.csr_array(S, device="cpu"), arg)
    assert isinstance(T, tsparse.csr_array) and T.device.type == "cpu"
    assert T.shape == J.shape and str(T.dtype) == f"torch.{J.dtype}"
    np.testing.assert_array_equal(T.toarray().numpy(), np.asarray(J.toarray()))
    T32 = tsparse.csr_array.make_with_same_nnz_structure(
        tsparse.csr_array(S, device="cpu"), arg, dtype=np.float32)
    assert T32.dtype == torch.float32


@pytest.mark.parametrize("shards,rps", [(1, 5), (8, 37), (4, 1 << 29)])
def test_shard_row_starts(shards, rps):
    from legate_sparse_tpu.parallel.dist_csr import DistCSR as JDist
    from legate_sparse_tpu_torch.parallel.dist_csr import DistCSR as TDist

    ns = SimpleNamespace(num_shards=shards, rows_per_shard=rps)
    got = TDist.shard_row_starts.fget(ns)
    want = JDist.shard_row_starts.fget(ns)
    assert got.dtype == want.dtype == np.int64
    np.testing.assert_array_equal(got, want)


def test_factor_int():
    from legate_sparse_tpu import utils as jutils
    from legate_sparse_tpu_torch import utils as tutils

    for n in range(1, 130):
        assert tutils.factor_int(n) == jutils.factor_int(n)


def test_types_aliases_and_autotune_enabled():
    from legate_sparse_tpu import autotune as jautotune
    from legate_sparse_tpu import types as jtypes
    from legate_sparse_tpu_torch import autotune as tautotune
    from legate_sparse_tpu_torch import types as ttypes

    for n in ("float32", "float64", "complex64", "complex128", "int32",
              "int64", "uint64"):
        assert getattr(ttypes, n) == getattr(jtypes, n)
        assert isinstance(getattr(ttypes, n), np.dtype)
    saved = (jsettings.autotune, tsettings.autotune)
    try:
        for on in (False, True):
            jsettings.autotune = tsettings.autotune = on
            assert tautotune.autotune_enabled() is jautotune.autotune_enabled()
    finally:
        jsettings.autotune, tsettings.autotune = saved
    assert tsparse.CompressedBase is tsparse.base.CompressedBase


def test_runtime_on_the_cpu(monkeypatch):
    import torch.distributed as dist

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    assert not dist.is_initialized()
    rt = runtime.Runtime()
    assert (rt.num_devices, rt.num_procs, rt.num_gpus) == (1, 1, 0)
    assert rt.default_float is runtime.default_float is torch.float64
    with pytest.raises(runtime.NoProcessGroupError, match="every rank"):
        rt.default_mesh
    sentinel = object()
    rt.set_default_mesh(sentinel)
    assert rt.default_mesh is sentinel
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert rt.num_devices == rt.num_procs == rt.num_gpus == 4
    runtime.set_device("cpu")
    try:
        assert rt.num_devices == 1 and rt.num_gpus == 4
    finally:
        runtime.set_device(None)
    assert isinstance(runtime.runtime, runtime.Runtime)


# ---- the plain ops functions the walk added ---------------------------
def _j(a):
    import jax.numpy as jnp

    return jnp.asarray(a)


def _t(a):
    return torch.as_tensor(np.asarray(a))


def test_ops_package_reexports():
    from legate_sparse_tpu import ops as jops
    from legate_sparse_tpu_torch import ops as tops
    from legate_sparse_tpu_torch.ops import convert, dia_ops, spgemm, spmv

    assert tops.dia_spmv is dia_ops.dia_spmv
    assert tops.dia_spmm is dia_ops.dia_spmm
    assert tops.csr_spmv is spmv.csr_spmv
    assert tops.coalesce_coo is spgemm.coalesce_coo
    assert tops.coo_to_csr is convert.coo_to_csr
    assert set(tops.kernel_wrappers()) == {"dia_spmv", "bsr_spmv",
                                           "dia_spmm", "bsr_spmm",
                                           "dia_spgemm"}
    assert all(hasattr(tops, n) for n in dir(jops)
               if not n.startswith("_") and callable(getattr(jops, n))
               and not inspect.ismodule(getattr(jops, n)))


def test_plain_dia_products():
    from legate_sparse_tpu.ops import dia_ops as jd
    from legate_sparse_tpu_torch.ops import dia_ops as td

    rng = np.random.default_rng(5)
    n, offs = 11, (-2, 0, 3)
    data = rng.standard_normal((3, n))
    x = rng.standard_normal(n)
    np.testing.assert_array_equal(
        td.dia_spmv(_t(data), _t(x), offs, (n, n)).numpy(),
        np.asarray(jd.dia_spmv(_j(data), _j(x), offs, (n, n))))
    offs_b = (-1, 1)
    b = rng.standard_normal((2, n))
    offs_c = tuple(sorted({a + c for a in offs for c in offs_b}))
    np.testing.assert_array_equal(
        td.dia_spgemm(_t(data), _t(b), offs, offs_b, offs_c, (n, n),
                      (n, n)).numpy(),
        np.asarray(jd.dia_spgemm(_j(data), _j(b), offs, offs_b, offs_c,
                                 (n, n), (n, n))))


def test_plain_coo_and_csr_helpers():
    """``coalesce_coo``, which does the job of the JAX package's
    excluded ``sort_coo``/``run_heads``/``compress_coo``, and the
    ``ell_pack_device`` alias, against the JAX package."""
    from legate_sparse_tpu.ops import spgemm as jg
    from legate_sparse_tpu.ops import spmv as js
    from legate_sparse_tpu_torch.ops import spgemm as tg
    from legate_sparse_tpu_torch.ops import spmv as ts

    rng = np.random.default_rng(7)
    rows = rng.integers(0, 5, 30)
    cols = rng.integers(0, 4, 30)
    vals = rng.standard_normal(30)
    for a, b in zip(tg.coalesce_coo(_t(rows), _t(cols), _t(vals), 5, 4),
                    jg.coalesce_coo(_j(rows), _j(cols), _j(vals), 5)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))

    S = _scipy_csr(seed=11, shape=(8, 6))
    assert ts.ell_pack_device is ts.ell_pack
    W = int(np.diff(S.indptr).max())
    for a, b in zip(ts.ell_pack_device(_t(S.data), _t(S.indices),
                                       _t(S.indptr), 8, W),
                    js.ell_pack_device(_j(S.data), _j(S.indices),
                                       _j(S.indptr), 8, W)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_bsr_spmv_xla():
    """The port's plain BSR product over its block list, which stands
    for the excluded ``bsr_spmv_xla``, against it on the same matrix."""
    from legate_sparse_tpu.ops import bsr as jb
    from legate_sparse_tpu_torch.ops import bsr as tb
    from legate_sparse_tpu_torch.ops.convert import row_ids_from_indptr

    rng = np.random.default_rng(9)
    S = sp.random(300, 260, density=0.02, format="csr", dtype=np.float32,
                  random_state=rng)
    blkT, brow, bcol, nbr, nbc = jb.bsr_pack(S.data, S.indices, S.indptr,
                                             S.shape, max_expand=1e9)[:5]
    indptr = torch.from_numpy(S.indptr.astype(np.int64))
    st = tb.build_structure(_t(S.data), _t(S.indices), indptr,
                            row_ids_from_indptr(indptr, S.nnz), S.shape,
                            max_expand=1e9)
    assert (st.nbr, st.nbc) == (nbr, nbc)
    x2d = rng.standard_normal((nbc, 128)).astype(np.float32)
    want = np.asarray(jb.bsr_spmv_xla(_j(blkT), _j(brow), _j(bcol),
                                      _j(x2d), nbr, nbc))
    got = tb.bsr_spmv_plain(st, _t(x2d)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6,
                               atol=1e-6 * np.abs(want).max())
