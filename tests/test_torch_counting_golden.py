"""The port's counting against the reference velocyto.py engine's own
output: every key of counting_golden.npz (each logic with and without
the repeat mask, the chr UMI extension, discovery mode), bitwise, and
the mid__Permissive10X digest of realistic_golden.npz through the
port's CLI (`velocyto run`: native cell sort, both passes, loom)."""
import json
import os
import sys

import numpy as np
import pytest
from click.testing import CliRunner

from velocyto_tpu_torch.counting.counter import ExInCounter
from velocyto_tpu_torch.counting.logics import LOGICS

HERE = os.path.join(os.path.dirname(__file__), "golden")
GOLDEN = os.path.join(HERE, "counting_golden.npz")
REALISTIC = os.path.join(HERE, "realistic_golden.npz")

ALL = ["Permissive10X", "Intermediate10X", "ValidatedIntrons10X",
       "Stricter10X", "ObservedSpanning10X", "Discordant10X", "SmartSeq2"]
VALID = {f"C{c:03d}" for c in range(15)}


@pytest.fixture(scope="module")
def golden():
    return np.load(GOLDEN)


def _count(logic_name, use_mask=False, valid=VALID, umi_extension="no"):
    counter = ExInCounter("s", LOGICS[logic_name],
                          valid_bcset=set(valid) if valid else None,
                          umi_extension=umi_extension)
    counter.peek(os.path.join(HERE, "cnt_fix.bam"))
    counter.read_transcriptmodels(os.path.join(HERE, "cnt_ann.gtf"))
    if use_mask:
        counter.read_repeats(os.path.join(HERE, "cnt_mask.gtf"))
    counter.mark_up_introns([os.path.join(HERE, "cnt_fix.bam")],
                            multimap=False)
    d, cell_order = counter.count(
        [os.path.join(HERE, "cnt_fix_cellsorted.bam")], multimap=False,
        cell_batch_size=5)
    order = np.argsort(cell_order)
    return ({layer: (np.concatenate(arrs, axis=1)[:, order] if arrs
                     else np.zeros((0, 0)))
             for layer, arrs in d.items()},
            np.array(cell_order)[order])


def _assert_golden(golden, key, layers, cells):
    np.testing.assert_array_equal(cells, golden[f"{key}__cells"])
    for layer, m in layers.items():
        want = golden[f"{key}__{layer}"]
        assert m.shape == want.shape, (key, layer)
        np.testing.assert_array_equal(m, want, err_msg=f"{key} {layer}")


@pytest.mark.parametrize("use_mask", [False, True], ids=["nomask", "mask"])
@pytest.mark.parametrize("logic_name", ALL)
def test_counting_matches_reference_engine(golden, logic_name, use_mask):
    layers, cells = _count(logic_name, use_mask)
    _assert_golden(golden, logic_name + ("_mask" if use_mask else ""),
                   layers, cells)
    assert sum(int(m.sum()) for m in layers.values()) > 0


def test_umi_chr_extension_matches_reference_engine(golden):
    layers, cells = _count("Permissive10X", umi_extension="chr")
    _assert_golden(golden, "ext_chr", layers, cells)


def test_discovery_mode_matches_reference_engine(golden):
    layers, cells = _count("Permissive10X", valid=None)
    _assert_golden(golden, "discovery", layers, cells)


def test_every_golden_key_is_held(golden):
    """The cases above cover the whole archive."""
    cases = {lg + sfx for lg in ALL for sfx in ("", "_mask")}
    cases |= {"ext_chr", "discovery"}
    assert {k.split("__")[0] for k in golden.keys()} == cases


def test_cli_run_realistic_matches_reference_digest(tmp_path):
    sys.path.insert(0, HERE)
    import realistic
    from velocyto_tpu_torch.commands.run import run
    from velocyto_tpu_torch.io import loom as vloom

    want = json.loads(str(np.load(REALISTIC, allow_pickle=True)[
        "mid__Permissive10X"]))
    paths = realistic.build(HERE, "mid")
    result = CliRunner().invoke(run, [
        paths["bam"], paths["gtf"], "-b", paths["bcs"],
        "-o", str(tmp_path), "-e", "real", "-l", "Permissive10X",
        "-t", "uint32",
    ])
    assert result.exit_code == 0, result.output
    ds = vloom.connect(os.path.join(str(tmp_path), "real.loom"))
    try:
        layers = {name: ds.layer[name][:, :]
                  for name in ("spliced", "unspliced", "ambiguous")}
        cells = [c.split(":")[-1] for c in ds.col_attrs["CellID"]]
    finally:
        ds.close()
    assert len(cells) == realistic.CONFIGS["mid"]["n_cells"]
    cells = [c.split("-")[0].rstrip("x") for c in cells]
    assert realistic.matrix_digest(layers, cells) == want
