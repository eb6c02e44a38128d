"""The port's file I/O held against the JAX package: the cases of
tests/test_io.py (Matrix Market into a ``TripletMatrix``, ``.smmdt`` save
and load, dispatch by extension), each put to both packages with the same
text and files, round trips through ``tmp_path``; the native and the
pure-Python Matrix Market parsers of the port held to each other; and
``sherman1_tiled``.  Parsing is exact, so values are compared for equality.
Cases that read the reference's assets skip through ``conftest.asset_path``.
"""

import io

import numpy as np
import pytest
import torch
import torch_port_threads  # noqa: F401  (one intra-op thread per test process)

import sparse_matrix_math_tpu as jsmm
import sparse_matrix_math_tpu_torch as smm
from conftest import MESH_MATRICES, SHERMAN1, asset_path
from sparse_matrix_math_tpu.utils import generate as jax_gen
from sparse_matrix_math_tpu_torch import native
from sparse_matrix_math_tpu_torch.io import matrix_market as MM

S = smm.MatrixLoadStatus

SYMMETRIC_MTX = """%%MatrixMarket matrix coordinate real symmetric
% comment line
5 5 6
1 1 4.0
2 2 5.0
3 3 6.0
2 1 -1.0
4 3 0.0
5 5 2.5
"""


def _same_triplet(t, j):
    assert t.shape == j.shape and t.nnz == j.nnz
    assert list(t) == list(j)


def test_symmetric_load_mirrors_offdiagonal():
    t = smm.load_matrix_market(io.StringIO(SYMMETRIC_MTX))
    j = jsmm.load_matrix_market(io.StringIO(SYMMETRIC_MTX))
    _same_triplet(t, j)
    assert isinstance(t, smm.TripletMatrix) and t.shape == (5, 5)
    # (2,1) mirrored to (1,2), reference h:2596-2601
    assert t.get_value(1, 0) == t.get_value(0, 1) == -1.0
    # an explicit zero is a stored entry
    assert (3, 2) in {(r, c) for r, c, _ in t} and t.get_value(3, 2) == 0.0
    assert t.get_value(4, 4) == 2.5


def test_path_and_file_object_agree(tmp_path):
    path = tmp_path / "m.mtx"
    path.write_text(SYMMETRIC_MTX)
    _same_triplet(smm.load_matrix_market(path), smm.load_matrix_market(io.StringIO(SYMMETRIC_MTX)))
    _same_triplet(smm.load_matrix_market(str(path), dtype=torch.float32),
                  jsmm.load_matrix_market(str(path), dtype=np.float32))


@pytest.mark.parametrize("name", MESH_MATRICES[:1] + ["load_symmetric_test.mtx"])
def test_reference_assets_load(name):
    path = asset_path(name)
    t, j = smm.load_matrix_market(path), jsmm.load_matrix_market(path)
    _same_triplet(t, j)
    tcsr = smm.csr_from_triplet(t, device="cpu")
    dense = tcsr.to_dense()
    assert torch.equal(dense, dense.T)  # symmetric expansion


@pytest.mark.parametrize("banner,status", [
    ("%%MatrixMarket matrix coordinate real general", S.UNSUPPORTED_FORMAT),
    ("%%MatrixMarket matrix coordinate complex symmetric", S.UNSUPPORTED_FORMAT),
    ("%%MatrixMarket matrix array real symmetric", S.UNSUPPORTED_FORMAT),
    ("%%MatrixMarket matrix coordinate pattern symmetric", S.UNSUPPORTED_FORMAT),
    ("not a banner at all", S.PARSE_ERROR),
], ids=["general", "complex", "array", "pattern", "no-banner"])
def test_rejected_banners(banner, status):
    """Only coordinate real|integer symmetric (h:2544-2573), the same status
    in both packages."""
    text = banner + "\n1 1 1\n1 1 1.0\n"
    for load in (smm.load_matrix_market, jsmm.load_matrix_market):
        with pytest.raises((smm.MatrixMarketError, jsmm.MatrixMarketError)) as exc:
            load(io.StringIO(text))
        assert int(exc.value.status) == int(status)


def test_general_allowed_with_flag():
    text = "%%MatrixMarket matrix coordinate real general\n2 2 2\n1 2 3.0\n2 1 4.0\n"
    t = smm.load_matrix_market(io.StringIO(text), allow_general=True)
    _same_triplet(t, jsmm.load_matrix_market(io.StringIO(text), allow_general=True))
    assert (t.get_value(0, 1), t.get_value(1, 0)) == (3.0, 4.0)


def test_integer_field_accepted():
    text = "%%MatrixMarket matrix coordinate integer symmetric\n2 2 1\n2 1 7\n"
    t = smm.load_matrix_market(io.StringIO(text))
    _same_triplet(t, jsmm.load_matrix_market(io.StringIO(text)))
    assert t.get_value(1, 0) == t.get_value(0, 1) == 7.0


def test_wrong_entry_count_is_parse_error():
    text = "%%MatrixMarket matrix coordinate real symmetric\n2 2 3\n1 1 1.0\n"
    with pytest.raises(smm.MatrixMarketError) as exc:
        smm.load_matrix_market(io.StringIO(text))
    assert exc.value.status == S.PARSE_ERROR


NATIVE_CASES = {
    "symmetric": (SYMMETRIC_MTX, False),
    "general": ("%%MatrixMarket matrix coordinate real general\n3 4 4\n1 4 1.0\n"
                "2 2 3.0\n3 1 -1.0\n1 4 0.5\n", True),
    "integer": ("%%MatrixMarket matrix coordinate integer symmetric\n3 3 2\n2 1 7\n3 3 1\n", False),
    "unsupported": ("%%MatrixMarket matrix coordinate real general\n2 2 1\n1 1 1.0\n", False),
    "array": ("%%MatrixMarket matrix array real general\n1 1\n1.0\n", True),
    "count": ("%%MatrixMarket matrix coordinate real symmetric\n2 2 3\n1 1 1.0\n", False),
    "bounds": ("%%MatrixMarket matrix coordinate real symmetric\n2 2 1\n3 1 1.0\n", False),
}


@pytest.mark.parametrize("case", list(NATIVE_CASES))
def test_native_and_python_parsers_agree(tmp_path, case):
    """``native.mtx_read`` (csrc/smm_native.cpp) and the Python parser give
    the same entries in the same order, or refuse with the same status;
    ``load_matrix_market_coo`` (native first) gives JAX's COO arrays."""
    if not native.available():
        pytest.skip("the native library did not build (no C++ compiler)")
    text, general = NATIVE_CASES[case]
    path = tmp_path / "m.mtx"
    path.write_text(text)
    try:
        py = MM._parse_path(path, general)
    except smm.MatrixMarketError as e:
        with pytest.raises(native.MtxNativeError) as exc:
            native.mtx_read(str(path), general)
        assert exc.value.status == e.status
        with pytest.raises(jsmm.MatrixMarketError) as jexc:
            jsmm.load_matrix_csr(str(path), allow_general=general)
        assert int(jexc.value.status) == int(e.status)
        return
    n_rows, n_cols, r, c, v = native.mtx_read(str(path), general)
    assert (n_rows, n_cols) == py[3]
    assert r.tolist() == py[0] and c.tolist() == py[1] and v.tolist() == py[2]
    coo = MM.load_matrix_market_coo(path, allow_general=general, device="cpu")
    jcsr = jsmm.load_matrix_csr(str(path), allow_general=general)
    tcsr = smm.load_matrix_csr(path, allow_general=general, device="cpu")
    for f in ("indptr", "indices", "data"):
        np.testing.assert_array_equal(getattr(tcsr, f).numpy(), np.asarray(getattr(jcsr, f)))
    np.testing.assert_array_equal(coo.vals.numpy(), tcsr.data.numpy())


def test_save_load_roundtrip(tmp_path):
    """Reference csr.cpp:828-865: through a file, zeros skipped on ingest
    (h:2634-2636); the port's file is the JAX package's byte for byte."""
    dense = np.array([[1.5, 0.0, 2.0], [0.0, 0.0, 0.0], [-3.25, 0.0, 4.0]])
    tpath, jpath = tmp_path / "t.smmdt", tmp_path / "j.smmdt"
    smm.save_dense_text(tpath, smm.csr_from_dense(dense, device="cpu"))
    jsmm.save_dense_text(jpath, jsmm.csr_from_dense(dense))
    assert tpath.read_bytes() == jpath.read_bytes()
    t, j = smm.load_smmdt(tpath), jsmm.load_smmdt(jpath)
    _same_triplet(t, j)
    assert t.nnz == 4
    np.testing.assert_array_equal(t.to_dense(device="cpu").numpy(), dense)


@pytest.mark.parametrize("what", ["csr", "triplet", "tensor", "array"])
def test_save_format_grammar(what):
    dense = np.array([[0.0, 1.0], [2.0, 0.0]])
    trip = smm.TripletMatrix(2, 2)
    trip.add_entry(0, 1, 1.0)
    trip.add_entry(1, 0, 2.0)
    matrix = {"csr": smm.csr_from_dense(dense, device="cpu"), "triplet": trip,
              "tensor": torch.from_numpy(dense), "array": dense}[what]
    buf, jbuf = io.StringIO(), io.StringIO()
    smm.save_dense_text(buf, matrix)
    jsmm.save_dense_text(jbuf, jsmm.csr_from_dense(dense))
    assert buf.getvalue() == jbuf.getvalue()
    assert buf.getvalue().splitlines() == ["2 2", "{", "{0,1.000000},", "{2.000000,0}", "}"]


def test_smmdt_parse_errors(tmp_path):
    for text in ("1 2 3\n{{1,2}}", "2 2\n{{1,2}}", "1 2\n{{1}}"):
        for load in (smm.load_smmdt, jsmm.load_smmdt):
            with pytest.raises((smm.MatrixMarketError, jsmm.MatrixMarketError)) as exc:
                load(io.StringIO(text))
            assert int(exc.value.status) == int(S.PARSE_ERROR)


def test_dispatch_by_extension(tmp_path):
    dense = np.eye(3) * 2.0
    path = tmp_path / "m.smmdt"
    smm.save_dense_text(path, smm.csr_from_dense(dense, device="cpu"))
    t, j = smm.load_matrix(path), jsmm.load_matrix(path)
    _same_triplet(t, j)
    tcsr = smm.load_matrix_csr(path, device="cpu")
    jcsr = jsmm.load_matrix_csr(path)
    for f in ("indptr", "indices", "data"):
        np.testing.assert_array_equal(getattr(tcsr, f).numpy(), np.asarray(getattr(jcsr, f)))
    df = smm.load_matrix_df(path, device="cpu")
    np.testing.assert_array_equal((df.diags_hi.double() + df.diags_lo.double()).numpy(),
                                  np.full((1, 3), 2.0))
    mtx = tmp_path / "m.mtx"
    mtx.write_text(SYMMETRIC_MTX)
    _same_triplet(smm.load_matrix(mtx), jsmm.load_matrix(mtx))


@pytest.mark.parametrize("name", ["matrix.txt", "matrix", "m.mtx.gz"])
def test_dispatch_unknown_extension(name):
    for load in (smm.load_matrix, lambda p: smm.load_matrix_csr(p, device="cpu"),
                 lambda p: smm.load_matrix_df(p, device="cpu"), jsmm.load_matrix):
        with pytest.raises((smm.MatrixMarketError, jsmm.MatrixMarketError)) as exc:
            load(name)
        assert int(exc.value.status) == int(S.FAILED_TO_OPEN_FILE_UNKNOWN_FORMAT)


def test_missing_file(tmp_path):
    for load in (smm.load_matrix_market, smm.load_smmdt, smm.load_matrix):
        for name in ("missing.mtx", "missing.smmdt"):
            if load is smm.load_smmdt and name.endswith(".mtx"):
                continue
            with pytest.raises(smm.MatrixMarketError) as exc:
                load(tmp_path / name)
            assert exc.value.status == S.FAILED_TO_OPEN_FILE


@pytest.mark.parametrize("jitter", [True, False])
def test_sherman1_tiled_matches_jax(tmp_path, monkeypatch, jitter):
    """The generator on a small seed file in place of sherman1: JAX's copies,
    column jitter and summed collisions, entry for entry; the seed file
    from SMM_SHERMAN1_MTX, and a clear error without one."""
    path = tmp_path / "seed.mtx"
    path.write_text(SYMMETRIC_MTX)
    t = smm.sherman1_tiled(3, seed=5, mtx_path=str(path), jitter=jitter, device="cpu")
    j = jax_gen.sherman1_tiled(3, seed=5, mtx_path=str(path), jitter=jitter)
    for f in ("indptr", "indices", "data"):
        np.testing.assert_array_equal(getattr(t, f).numpy(), np.asarray(getattr(j, f)))
    monkeypatch.setenv("SMM_SHERMAN1_MTX", str(path))
    assert torch.equal(smm.sherman1_tiled(3, seed=5, jitter=jitter, device="cpu").data, t.data)
    monkeypatch.delenv("SMM_SHERMAN1_MTX")
    with pytest.raises(FileNotFoundError):
        smm.sherman1_tiled(2, device="cpu")


def test_sherman1_tiled_asset():
    path = asset_path(SHERMAN1)
    t = smm.sherman1_tiled(4, mtx_path=path, device="cpu")
    j = jax_gen.sherman1_tiled(4, mtx_path=path)
    for f in ("indptr", "indices", "data"):
        np.testing.assert_array_equal(getattr(t, f).numpy(), np.asarray(getattr(j, f)))
