"""The port's table I/O (gaplac_tpu_torch/data/io.py) against gaplac_tpu's:
the same bytes written, the same frames read (values and dtypes)."""

import numpy as np
import pandas as pd
import pytest

from gaplac_tpu.data import io as jax_io
from gaplac_tpu_torch.data import io as torch_io


def _numeric_table():
    rng = np.random.default_rng(0)
    special = np.array([0.0, -0.0, 1.0, -3.0, 1e15 - 1, 1e15, 1e20, 1e-5, 0.1, np.inf, -np.inf,
                        np.nan, -np.nan, 2.0 ** 60, 123456789.0, -1e-300])
    return pd.DataFrame({
        "iteration": np.arange(1, 17),
        "ℓ": rng.uniform(0, 20, 16),
        "fx[1]": rng.normal(size=16) * 10.0 ** rng.integers(-8, 8, 16),
        "special": special,
        "lp": -rng.exponential(100, 16),
    })


@pytest.mark.parametrize("ext", ["tsv", "csv"])
def test_numeric_writer_matches_jax_bytes(tmp_path, ext):
    df = _numeric_table()
    paths = [tmp_path / f"{tag}.{ext}" for tag in ("jax", "torch")]
    jax_io.df_output(df, str(paths[0]))
    torch_io.df_output(df, str(paths[1]))
    assert paths[0].read_bytes() == paths[1].read_bytes()


_TABLES = {
    "mixed": "PersonID\ty\tz\na\t1.0\t2\nb\t2.5\t3\n",
    "missing": "a,b\n1.0,\n,2.5\n",
    "quoted_header": '"x","y"\n1.5,2.5\n3.0,4.0\n',
    "short_row": "a,b,c\n1,2\n3,4,5\n",
    "integers": "x\ty\n1\t2\n3\t4\n",
    "legacy_comma_in_tsv": "x,y\n0.30000000000000004,1e-7\n-2,3.5\n",
    "booleans": "x\tflag\n1.0\tTrue\n2.0\tFalse\n",
}


@pytest.mark.parametrize("name", sorted(_TABLES))
def test_read_table_matches_jax(tmp_path, name):
    path = tmp_path / f"{name}.tsv"
    path.write_text(_TABLES[name])
    pd.testing.assert_frame_equal(torch_io.read_table(str(path)), jax_io.read_table(str(path)))


def test_written_table_reads_back_exactly(tmp_path):
    df = _numeric_table()
    path = tmp_path / "chain.tsv"
    torch_io.df_output(df, str(path))
    back = torch_io.read_table(str(path))
    assert list(back.columns) == list(df.columns)
    np.testing.assert_array_equal(back.to_numpy(), df.to_numpy(dtype=np.float64))
    pd.testing.assert_frame_equal(back, jax_io.read_table(str(path)))
