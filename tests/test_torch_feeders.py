"""The port's multi-host counting driver (parallel.feeders.count_distributed)
and its count merge (parallel.counts), mirroring tests/test_feeders.py and
tests/test_parallel_counts.py: feeder processes over barcode ranges,
merged on a mesh of CPU shards or on the host, bit-identical to the serial
pass (values and column order) and to the JAX package's driver."""
import numpy as np
import pytest
import torch

from velocyto_tpu.parallel import count_distributed as jcount_distributed
from velocyto_tpu.parallel.counts import merge_feeder_counts as jmerge
from velocyto_tpu.parallel import make_mesh as jmake_mesh

from velocyto_tpu_torch.counting.counter import ExInCounter
from velocyto_tpu_torch.counting.logics import Permissive10X
from velocyto_tpu_torch.parallel import (count_distributed, make_mesh,
                                         merge_feeder_counts,
                                         merge_feeder_counts_np)

from test_torch_fastpath import (annotation, _random_bam,  # noqa: F401
                                 _cellsort)

CPU = torch.device("cpu")


def _serial(gtf, bam_cs, bam_pos, bcs):
    counter = ExInCounter(sampleid="s", logic=Permissive10X,
                          valid_bcset=set(bcs))
    counter.peek(bam_pos)
    counter.read_transcriptmodels(gtf)
    counter.mark_up_introns([bam_pos], multimap=False)
    d, order = counter.count([bam_cs], multimap=False, cell_batch_size=5)
    layers = {k: (np.concatenate(v, axis=1) if v else
                  np.zeros((len(counter.geneid2ix), 0)))
              for k, v in d.items()}
    return layers, order


@pytest.fixture
def fixture(tmp_path, annotation):      # noqa: F811
    gtf, genes = annotation
    bam_pos, bcs = _random_bam(tmp_path, genes, seed=11, n_reads=900,
                               n_cells=10)
    bam_cs = _cellsort(tmp_path, bam_pos)
    return gtf, bam_cs, bam_pos, bcs


@pytest.mark.parametrize("n_feeders", [2, 3])
def test_feeders_match_serial(fixture, n_feeders):
    gtf, bam_cs, bam_pos, bcs = fixture
    serial_layers, serial_order = _serial(gtf, bam_cs, bam_pos, bcs)
    kw = dict(valid_bcs=sorted(bcs), logic_name="Permissive10X",
              markup_bamfiles=[bam_pos], n_feeders=n_feeders,
              cell_batch_size=5, mesh=None, in_process=True)
    layers, order = count_distributed([bam_cs], gtf, **kw)
    j_layers, j_order = jcount_distributed([bam_cs], gtf, **kw)
    # bit-identical INCLUDING the column order (serial first-encounter)
    assert order == serial_order == j_order
    total = 0
    for layer in serial_layers:
        np.testing.assert_array_equal(layers[layer], serial_layers[layer],
                                      err_msg=f"layer {layer}")
        np.testing.assert_array_equal(layers[layer], j_layers[layer])
        assert layers[layer].dtype == j_layers[layer].dtype
        total += int(layers[layer].sum())
    assert total > 0, "vacuous comparison: nothing counted"


def test_feeders_prepare_once(fixture, monkeypatch):
    """The annotation parse and the markup pass run exactly once however
    many feeders count."""
    calls = {"gtf": 0, "markup": 0}
    orig_gtf = ExInCounter.read_transcriptmodels
    orig_mark = ExInCounter.mark_up_introns

    def count_gtf(self, *a, **k):
        calls["gtf"] += 1
        return orig_gtf(self, *a, **k)

    def count_mark(self, *a, **k):
        calls["markup"] += 1
        return orig_mark(self, *a, **k)

    monkeypatch.setattr(ExInCounter, "read_transcriptmodels", count_gtf)
    monkeypatch.setattr(ExInCounter, "mark_up_introns", count_mark)
    gtf, bam_cs, bam_pos, bcs = fixture
    count_distributed(
        [bam_cs], gtf, valid_bcs=sorted(bcs), logic_name="Permissive10X",
        markup_bamfiles=[bam_pos], n_feeders=3, cell_batch_size=5,
        mesh=None, in_process=True)
    assert calls == {"gtf": 1, "markup": 1}


def test_pcount_matches_count_distributed_hash_owners(fixture):
    """pcount and the feeder driver share one worker mechanism: same
    values, same serial column order."""
    gtf, bam_cs, bam_pos, bcs = fixture
    counter = ExInCounter(sampleid="s", logic=Permissive10X,
                          valid_bcset=set(bcs))
    counter.peek(bam_pos)
    counter.read_transcriptmodels(gtf)
    counter.mark_up_introns([bam_pos], multimap=False)
    layers_cd, order_cd = count_distributed(
        [bam_cs], counter=counter, n_feeders=2, cell_batch_size=5,
        in_process=True)       # hash ownership (valid_bcs=None)
    serial_layers, serial_order = _serial(gtf, bam_cs, bam_pos, bcs)
    assert order_cd == serial_order
    for layer in serial_layers:
        np.testing.assert_array_equal(layers_cd[layer],
                                      serial_layers[layer])
    with pytest.raises(ValueError, match="gtffile"):
        count_distributed([bam_cs], n_feeders=2, in_process=True)


def test_feeders_mesh_merge_matches_host(fixture):
    gtf, bam_cs, bam_pos, bcs = fixture
    mesh = make_mesh(devices=[CPU] * 8)
    kw = dict(valid_bcs=sorted(bcs), logic_name="Permissive10X",
              markup_bamfiles=[bam_pos], n_feeders=2, cell_batch_size=5,
              in_process=True)
    l_mesh, o_mesh = count_distributed([bam_cs], gtf, mesh=mesh, **kw)
    l_host, o_host = count_distributed([bam_cs], gtf, mesh=None, **kw)
    assert o_mesh == o_host
    for layer in l_host:
        np.testing.assert_array_equal(l_mesh[layer], l_host[layer])


def test_feeders_spawn_processes(fixture):
    """Real spawned worker processes (the multi-host deployment shape)."""
    gtf, bam_cs, bam_pos, bcs = fixture
    serial_layers, serial_order = _serial(gtf, bam_cs, bam_pos, bcs)
    layers, order = count_distributed(
        [bam_cs], gtf, valid_bcs=sorted(bcs), logic_name="Permissive10X",
        markup_bamfiles=[bam_pos], n_feeders=2, cell_batch_size=5,
        mesh=None, in_process=False)
    assert sorted(order) == sorted(serial_order)
    ps = np.argsort(np.array(serial_order))
    pf = np.argsort(np.array(order))
    for layer in serial_layers:
        np.testing.assert_array_equal(layers[layer][:, pf],
                                      serial_layers[layer][:, ps])


def test_vtx_staleness_rejected(fixture, tmp_path):
    """A .vtx written for another BAM (stale after a re-sort) is rejected,
    so the feeders full-scan instead of seeking into the wrong stream;
    the result stays the serial one."""
    import shutil
    import struct
    from velocyto_tpu_torch import native
    from velocyto_tpu_torch.counting import soa_engine
    if not native.available():
        pytest.skip("the native engine did not build")
    gtf, bam_cs, bam_pos, bcs = fixture
    assert native.read_tag_index(bam_cs + ".vtx") is not None, \
        "the fixture's native sort should have written a .vtx"
    stale = str(tmp_path / "stale.bam")
    shutil.copy(bam_cs, stale)
    vtx = bytearray(open(bam_cs + ".vtx", "rb").read())
    (size,) = struct.unpack_from("<Q", vtx, 4)
    struct.pack_into("<Q", vtx, 4, size + 1000)
    open(stale + ".vtx", "wb").write(bytes(vtx))
    assert native.read_tag_index(stale + ".vtx") is None
    assert soa_engine.feeder_byte_ranges(stale, [frozenset(bcs)]) is None
    serial_layers, serial_order = _serial(gtf, bam_cs, bam_pos, bcs)
    layers, order = count_distributed(
        [stale], gtf, valid_bcs=sorted(bcs), logic_name="Permissive10X",
        markup_bamfiles=[bam_pos], n_feeders=2, cell_batch_size=5,
        in_process=True)
    assert order == serial_order
    for layer in serial_layers:
        np.testing.assert_array_equal(layers[layer], serial_layers[layer])


@pytest.mark.parametrize("dtype", [np.uint32, np.int64, np.float32])
def test_merge_feeder_counts(dtype):
    """The merge over a mesh of CPU shards equals the host sum and the JAX
    package's psum (tests/test_parallel_counts.py), for more feeders than
    shards and fewer."""
    rng = np.random.default_rng(0)
    for feeders in (6, 11):
        partials = rng.integers(0, 5, (feeders, 20, 30)).astype(dtype)
        got = merge_feeder_counts(make_mesh(devices=[CPU] * 8), partials)
        want = merge_feeder_counts_np(partials)
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(jmerge(jmake_mesh(), partials)))
    with pytest.raises(ValueError, match="feeders"):
        merge_feeder_counts(make_mesh(devices=[CPU]), partials[0])
