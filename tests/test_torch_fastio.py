"""The port's native numeric-table IO (gaplac_tpu_torch/data/fastio.py, its
own copy of native/fastio.cpp): the twins of tests/test_fastio.py, the
bytes it writes against gaplac_tpu's native writer and against its plain
version (data/io.py::_write_numeric), and a failed build that raises."""

import numpy as np
import pandas as pd
import pytest

from gaplac_tpu.data import fastio as jax_fastio
from gaplac_tpu_torch.data import fastio
from gaplac_tpu_torch.data import io as torch_io
from gaplac_tpu_torch.data.io import df_output, read_table


def _chain_table(rows=50, seed=0):
    rng = np.random.default_rng(seed)
    return pd.DataFrame({
        "iteration": np.arange(1.0, rows + 1.0),
        "ℓ": rng.uniform(0, 20, rows),
        "fx[1]": rng.normal(size=rows) * 10.0 ** rng.integers(-8, 8, rows),
        "lp": -rng.exponential(100, rows),
        "special": np.resize([0.0, -0.0, 1e15 - 1, 1e15, 1e20, np.inf, -np.inf, np.nan, -np.nan,
                              2.0 ** 60, -1e-300], rows),
    })


def test_roundtrip_matches_pandas(tmp_path):
    df = _chain_table()
    path = tmp_path / "chain.tsv"
    df_output(df, str(path))                       # native writer
    back = read_table(str(path))                   # native reader
    assert list(back.columns) == list(df.columns)  # the unicode ℓ too
    np.testing.assert_array_equal(back.to_numpy(), df.to_numpy())
    pdf = pd.read_csv(path, sep="\t", float_precision="round_trip")
    np.testing.assert_array_equal(pdf.to_numpy(), df.to_numpy())


def test_mixed_table_goes_to_pandas(tmp_path):
    df = pd.DataFrame({"PersonID": ["a", "b"], "y": [1.0, 2.0]})
    path = tmp_path / "mixed.tsv"
    df.to_csv(path, sep="\t", index=False)
    assert fastio.read_numeric(str(path), "\t") is None
    back = read_table(str(path))
    assert list(back["PersonID"]) == ["a", "b"]


def test_missing_values(tmp_path):
    path = tmp_path / "m.csv"
    path.write_text("a,b\n1.0,\n,2.5\n")
    back = read_table(str(path))
    assert np.isnan(back["b"][0]) and np.isnan(back["a"][1])
    assert back["a"][0] == 1.0 and back["b"][1] == 2.5


def test_short_row_yields_nan_not_shift(tmp_path):
    path = tmp_path / "short.csv"
    path.write_text("a,b,c\n1,2\n3,4,5\n")
    names, arr = fastio.read_numeric(str(path), ",")
    assert names == ["a", "b", "c"] and arr.shape == (2, 3)
    np.testing.assert_array_equal(arr[0, :2], [1.0, 2.0])
    assert np.isnan(arr[0, 2])
    np.testing.assert_array_equal(arr[1], [3.0, 4.0, 5.0])


def test_quoted_header_unquoted(tmp_path):
    p = tmp_path / "r.csv"
    p.write_text('"x","y"\n1.5,2.5\n3.0,4.0\n')
    assert list(read_table(str(p)).columns) == ["x", "y"]
    assert fastio.read_numeric(str(p), ",")[0] == ["x", "y"]


def test_extra_field_row_goes_to_pandas(tmp_path):
    """A row with more fields than the header is not cut short."""
    p = tmp_path / "bad.csv"
    p.write_text("a,b\n1,2,99\n")
    assert fastio.read_numeric(str(p), ",") is None


@pytest.mark.parametrize("ext, sep", [("tsv", "\t"), ("csv", ",")])
def test_written_bytes_match_jax_native_and_the_plain_writer(tmp_path, ext, sep):
    if not jax_fastio.available():
        pytest.fail("gaplac_tpu's native writer did not build")
    df = _chain_table(rows=400, seed=2)
    names = [str(c) for c in df.columns]
    port, ref, plain = (tmp_path / f"{tag}.{ext}" for tag in ("port", "jax", "plain"))
    fastio.write_numeric(str(port), sep, names, df.to_numpy())
    assert jax_fastio.write_numeric(str(ref), sep, names, df.to_numpy())
    torch_io._write_numeric(str(plain), sep, df)
    assert port.read_bytes() == ref.read_bytes() == plain.read_bytes()
    got, want = fastio.read_numeric(str(port), sep), jax_fastio.read_numeric(str(ref), sep)
    assert got[0] == want[0]
    np.testing.assert_array_equal(got[1], want[1])


def test_unreadable_file_raises(tmp_path):
    with pytest.raises(OSError):
        fastio.read_numeric(str(tmp_path / "missing.tsv"), "\t")
    with pytest.raises(OSError):
        fastio.write_numeric(str(tmp_path / "no_dir" / "x.tsv"), "\t", ["a"], np.zeros((1, 1)))


def test_failed_build_raises_with_the_compilers_message(tmp_path, monkeypatch):
    monkeypatch.setattr(fastio, "_lib", None)
    monkeypatch.setattr(fastio, "BUILD_DIR", tmp_path / "build")
    bad = tmp_path / "fastio.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(fastio, "SRC", bad)
    with pytest.raises(RuntimeError, match="failed with code"):
        fastio.library()
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    with pytest.raises(RuntimeError, match="did not run"):
        fastio.library()
