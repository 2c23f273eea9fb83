"""The port's loom reader (velocyto_tpu_torch.io.loom.connect) against
the JAX package's reader on the same files: a loom written by the
port's ``io.loom.create``, a loom v3 whose file attributes sit in an
``attrs`` group of scalar datasets (written with h5py), and the loom the
port's CLI writes for the tracked counting fixture
(tests/golden/cnt_fix.bam).  Both readers must agree on shape,
layers.keys(), ra / ca / row_attrs / col_attrs, attrs, the _Layer
views (shape, dtype, slices) and use in a ``with`` block."""
import os
import shutil

import h5py
import numpy as np
import pytest
from click.testing import CliRunner

from velocyto_tpu.io import loom as jloom
from velocyto_tpu_torch.io import loom as tloom

HERE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")


def _created(tmp_path):
    rng = np.random.RandomState(0)
    g, n = 37, 70
    main = rng.poisson(2.0, (g, n)).astype(np.float32)
    path = str(tmp_path / "created.loom")
    tloom.create(
        path,
        {"": main, "spliced": main.astype(np.uint32),
         "unspliced": rng.poisson(0.5, (g, n)).astype(np.uint32),
         "ambiguous": np.zeros((g, n), np.uint16)},
        {"Gene": np.array([f"g{i}" for i in range(g)]),
         "Accession": np.array([f"ENS{i:05d}" for i in range(g)]),
         "Start": np.arange(g, dtype=np.int64) * 10},
        {"CellID": np.array([f"s:c{i}" for i in range(n)]),
         "_Valid": np.ones(n, np.int8)},
        file_attrs={"velocyto.version": "x", "velocyto.logic": "Default"})
    return path


def _v3(tmp_path):
    rng = np.random.RandomState(1)
    path = str(tmp_path / "v3.loom")
    with h5py.File(path, "w") as f:
        f.create_dataset("matrix", data=rng.rand(12, 9).astype(np.float64))
        lg = f.create_group("layers")
        lg.create_dataset("spliced", data=rng.randint(0, 5, (12, 9)))
        f.create_group("row_attrs").create_dataset(
            "Gene", data=np.array([f"G{i}" for i in range(12)], "S"))
        f.create_group("col_attrs").create_dataset(
            "CellID", data=np.array([f"C{i}" for i in range(9)], "S"))
        at = f.create_group("attrs")
        at.create_dataset("LOOM_SPEC_VERSION", data=np.bytes_("3.0.0"))
        at.create_dataset("CreationDate", data=np.bytes_("20240101"))
        at.create_dataset("n_pcs", data=np.int64(7))
        f.attrs["legacy"] = "root attribute"
    return path


def _cli(tmp_path):
    from velocyto_tpu_torch.commands.run import run
    # the CLI writes its cell-sorted BAM beside the input: copy it out
    for name in ("cnt_fix.bam", "cnt_ann.gtf"):
        shutil.copy(os.path.join(HERE, name), tmp_path / name)
    bcs = tmp_path / "bcs.tsv"
    bcs.write_text("\n".join(f"C{i:03d}" for i in range(15)) + "\n")
    out = tmp_path / "cli"
    result = CliRunner().invoke(run, [
        str(tmp_path / "cnt_fix.bam"), str(tmp_path / "cnt_ann.gtf"),
        "-b", str(bcs), "-o", str(out), "-e", "fix", "-l", "Permissive10X"])
    assert result.exit_code == 0, result.output
    return str(out / "fix.loom")


FILES = {"created": _created, "v3": _v3, "cli": _cli}


def _same(a, b):
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    else:
        assert type(a) is type(b) and a == b


def _same_dict(a, b):
    assert list(a) == list(b)
    for k in a:
        _same(a[k], b[k])


@pytest.mark.parametrize("kind", sorted(FILES))
def test_reader_matches_jax(tmp_path, kind):
    path = FILES[kind](tmp_path)
    with tloom.connect(path) as ds, jloom.connect(path) as want:
        assert ds.shape == want.shape
        assert ds.layers.keys() == want.layers.keys()
        assert ds.layer.keys() == want.layers.keys()
        for name in want.layers.keys():
            got, ref = ds.layers[name], want.layers[name]
            assert got.shape == ref.shape and got.dtype == ref.dtype
            for key in ((slice(None), slice(None)), (slice(2, 5), 3),
                        (0, slice(None, None, 2))):
                _same(got[key], ref[key])
        for attr in ("ra", "ca", "row_attrs", "col_attrs", "attrs"):
            _same_dict(getattr(ds, attr), getattr(want, attr))
    assert not ds._f and not want._f     # the with block closed both


def test_cli_loom_cell_ids_and_v3_attrs(tmp_path):
    with tloom.connect(_cli(tmp_path)) as ds:
        cells = ds.ca["CellID"]
        assert len(cells) == ds.shape[1] > 0
        assert all(c.startswith("fix:") for c in cells)
        assert set(ds.layers.keys()) >= {"", "spliced", "unspliced",
                                         "ambiguous"}
    with tloom.connect(_v3(tmp_path)) as ds:
        assert ds.attrs["n_pcs"] == 7
        assert ds.attrs["LOOM_SPEC_VERSION"] == b"3.0.0"
        assert ds.attrs["legacy"] == "root attribute"
