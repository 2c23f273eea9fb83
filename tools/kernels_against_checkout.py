"""The dense, sampled and flat colDeltaCor kernels of this checkout against
those of another checkout of the port, bitwise, on one card, and the flat
kernel's time and the ring call's against the other's in the same run.

Loads the other checkout's velocyto_tpu_torch package under its own name,
builds both kernel sets, and runs the dense kernel (every transform, full
and partial semantics, both fields), the sampled kernel (every transform,
both fields) and the flat block-table kernel (every transform, both
fields, on every table of the ring plan of the sampled indices over 2
shards; this checkout's on each of its schedules) of each on the same
inputs at three shapes, two with G % 4 != 0.  Exits non-zero when any
output differs in one bit.  Use it to show
that a change to a kernel source left the launches it did not mean to
change as they were:

    git archive <commit> velocyto_tpu_torch | tar -x -C _archive/other
    python3 tools/kernels_against_checkout.py _archive/other

Then it times the flat kernels at the 20k operating point (G = 2000, nn =
1750, both fields, sqrt, the 4 tables of 2 shards), in turns: on uniform
indices, and on the default pipeline's own sampled indices
(bench_pipeline.run_once at 20,000 x 2,000, seed 0, the transition
stage's inputs captured), the other's in table order beside this
checkout's in table order and in the locality rank of the embedding.
On those indices it also times the whole ring call
(col_delta_cor_partial_ring_dev over 2 shards of the card) of both
checkouts in turns, each call's flat steps and final gather (the ring's
inner function) timed apart, this checkout's with the order, then one
more of this checkout's calls profiled for its pieces (its vtt.ring.*
spans), the outputs bitwise equal.  One JSON line.  Run
from the repo root, on a machine with a card and nvcc.
"""
import importlib.util
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke as cs                                    # noqa: E402
from velocyto_tpu_torch import kernels as ours             # noqa: E402
from velocyto_tpu_torch.ops.coldeltacor import _TRANSFORMS  # noqa: E402

SHAPES = ((37, 29), (2000, 4096), (1999, 3001))            # (G, N)
DENSE_CASES = ((0, 0.0, False), (1, 1e-10, False), (1, 1.0, True),
               (2, 1.0, False), (2, 1.0, True))   # (transform, psc, partial)
SAMPLED_CASES = ((0, 0.0), (1, 1e-10), (2, 1.0))
NN = 300
SHARDS = 2                     # the flat kernel's plans
TURNS = 3                      # timing rounds


def _load(checkout: str):
    """The other checkout's velocyto_tpu_torch package, as other_vtt (its
    modules import each other relatively)."""
    path = Path(checkout) / "velocyto_tpu_torch"
    spec = importlib.util.spec_from_file_location(
        "other_vtt", path / "__init__.py",
        submodule_search_locations=[str(path)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules["other_vtt"] = mod
    spec.loader.exec_module(mod)
    return mod


def _locality(points):
    """The locality order (ops.coldeltacor.locality_order) of an (n, 2)
    embedding, on the card."""
    from velocyto_tpu_torch.ops.coldeltacor import locality_order
    return locality_order(torch.as_tensor(np.asarray(points), device="cuda"))


def _bits(a, b):
    return a.shape == b.shape and bool(torch.equal(a.view(torch.int32),
                                                   b.view(torch.int32)))


def _pairs_same(a, b):
    return all(_bits(x[0], y[0]) and _bits(x[1], y[1]) for x, y in zip(a, b))


def _flat_bitwise(other, er, dr, d2r, ixs, g, n, res):
    """The flat kernels on every table of the plan over SHARDS shards:
    this checkout's in table order and in a locality rank, each against
    the other's."""
    order = _locality(np.random.RandomState(g).rand(n, 2))
    launches, _inv, _chunk = cs.flat_tables(er, dr, d2r, ixs, SHARDS, order)
    for tf, psc in SAMPLED_CASES:
        want = cs.flat_run(launches, tf, psc, None,
                           flat=other.coldeltacor_flat)
        for sched in ("table", "locality"):
            got = cs.flat_run(launches, tf, psc, sched)
            res[f"flat G={g} N={n} transform={tf} {sched}"] = \
                _pairs_same(got, want)


def _time_flat(other, name, e_rows, d_rows, d2_rows, ixs, order, tc, psc):
    """Median ms of the 4 flat launches summed: the other's (table order)
    and this checkout's in table order and in the locality rank, in
    turns; the outputs of every run bitwise equal to the other's."""
    launches, _inv, _chunk = cs.flat_tables(e_rows, d_rows, d2_rows, ixs,
                                            SHARDS, order)
    turns = [("other", dict(schedule=None, flat=other.coldeltacor_flat)),
             ("table", dict(schedule="table")),
             ("locality", dict(schedule="locality"))]
    times = {k: [] for k, _ in turns}
    ref, same = None, True
    for i in range(TURNS):
        for key, kw in (turns if i % 2 == 0 else turns[::-1]):
            t, out = cs._time_ms(
                lambda: cs.flat_run(launches, tc, psc, **kw))
            times[key].append(t)
            if ref is None:
                ref = out
            else:
                same = same and _pairs_same(out, ref)
    ms = {k: statistics.median(v) for k, v in times.items()}
    entries = sum(t["args"][3].numel() for t in launches)
    g = e_rows.shape[1]
    return {"ms": ms, "entries": entries, "bitwise": same,
            "gbps": {k: entries * g * 4 / (v / 1e3) / 1e9
                     for k, v in ms.items()},
            "locality_over_other": ms["locality"] / ms["other"],
            "table_over_other": ms["table"] / ms["other"], "name": name}


def _pipeline_indices():
    """The default pipeline's transition-stage inputs (bench_pipeline's
    data at 20,000 x 2,000, seed 0): the expression rows, both fields'
    displacement rows, the sampled ids, the embedding's locality order,
    the transform's name and psc."""
    from velocyto_tpu_torch import analysis, bench_pipeline
    S, U = bench_pipeline.synth(np.random.RandomState(0), cs.CELLS, cs.GENES)
    got = {"runs": []}
    chunked = analysis.make_partial_compact_chunked

    def capture(emat, tf, psc):
        got.update(emat=emat, tf=tf, psc=psc)
        prep_d, run = chunked(emat, tf, psc)

        def _run(d_rows, lo, hi, ixs, d_rows_random=None, order=None):
            got["runs"].append((d_rows, ixs, d_rows_random))
            return run(d_rows, lo, hi, ixs, d_rows_random, order=order)
        return prep_d, _run

    analysis.make_partial_compact_chunked = capture
    try:
        _total, _stages, v = bench_pipeline.run_once(S, U, "cuda", True)
    finally:
        analysis.make_partial_compact_chunked = chunked
    ixs = torch.cat([r[1] for r in got["runs"]])
    order = _locality(v.ts)
    return (got["emat"].to(torch.float32).T.contiguous(), got["runs"][0][0],
            got["runs"][0][2], ixs, order, got["tf"], got["psc"])


def _timed_inner(cdc, times):
    """Patch cdc.make_partial_ring so that each call of the ring's inner
    function (its flat steps and the gather through inv_pos) appends its
    seconds, the card synchronised around it, to times.  Returns the
    original, to put back."""
    make = cdc.make_partial_ring

    def timed(*args, **kw):
        fn = make(*args, **kw)

        def run(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            return out
        return run
    cdc.make_partial_ring = timed
    return make


def _ring_calls(pkg, e_rows, d_rows, d2_rows, ixs, order, tf, psc):
    """The whole ring call over SHARDS shards of the card, both fields, of
    the other checkout (pkg, no order) and of this one (the locality
    order), in turns (other, ours, ours, other): seconds of each call and
    of its inner function, the host seconds of this checkout's pieces in
    one more call, profiled (its vtt.ring.* spans), and whether all
    outputs are bitwise equal."""
    from velocyto_tpu_torch.ops import coldeltacor as cdc
    from velocyto_tpu_torch.parallel import make_mesh
    from velocyto_tpu_torch.utils.profiling import span_seconds, trace
    ocdc = importlib.import_module(pkg.__name__ + ".ops.coldeltacor")
    omake = importlib.import_module(pkg.__name__ + ".parallel").make_mesh
    devices = [torch.device("cuda", 0)] * SHARDS
    calls = {
        "other": lambda: ocdc.col_delta_cor_partial_ring_dev(
            omake(devices=devices), e_rows.T, d_rows.T, ixs, tf, psc,
            dmat_random=d2_rows.T),
        "ours": lambda: cdc.col_delta_cor_partial_ring_dev(
            make_mesh(devices=devices), e_rows.T, d_rows.T, ixs, tf, psc,
            dmat_random=d2_rows.T, order=order)}
    got = {k: {"call_s": [], "inner_s": []} for k in calls}
    ref, same = None, True
    for key in ("other", "ours", "ours", "other"):
        mod = ocdc if key == "other" else cdc
        make = _timed_inner(mod, got[key]["inner_s"])
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = calls[key]()
            torch.cuda.synchronize()
            got[key]["call_s"].append(time.perf_counter() - t0)
        finally:
            mod.make_partial_ring = make
        if ref is None:
            ref = out
        else:
            same = same and _bits(out[0], ref[0]) and _bits(out[1], ref[1])
        del out
    with trace() as prof:
        out = calls["ours"]()
        torch.cuda.synchronize()
    same = same and _bits(out[0], ref[0]) and _bits(out[1], ref[1])
    del out
    got["ours"]["split"] = {
        name[len("ring."):]: sec for name, (_n, sec)
        in span_seconds(prof).items() if name.startswith("ring.")}
    got["bitwise"] = same
    return got


def main(checkout: str) -> dict:
    pkg = _load(checkout)
    other = pkg.kernels
    ours.build()
    other.build()
    res = {}
    for g, n in SHAPES:
        rng = np.random.RandomState(g)
        e, d, d2 = (torch.tensor(a, dtype=torch.float32, device="cuda")
                    for a in (rng.rand(g, n) * 10, rng.randn(g, n),
                              rng.randn(g, n)))
        for tf, psc, partial in DENSE_CASES:
            a = ours.coldeltacor_dense(e, d, tf, psc, partial, dmat2=d2)
            b = other.coldeltacor_dense(e, d, tf, psc, partial, dmat2=d2)
            res[f"dense G={g} N={n} transform={tf} psc={psc} "
                f"partial={partial}"] = _bits(a[0], b[0]) and \
                _bits(a[1], b[1])
        er, dr, d2r = (t.T.contiguous() for t in (e, d, d2))
        gen = torch.Generator().manual_seed(g)
        nn = min(NN, n - 1)
        ixs = torch.stack([torch.randperm(n, generator=gen)[:nn]
                           for _ in range(n)]).to(torch.int32).cuda()
        for tf, psc in SAMPLED_CASES:
            a = ours.coldeltacor_partial(er, er, dr, ixs, tf, psc,
                                         d_ctr2=d2r)
            b = other.coldeltacor_partial(er, er, dr, ixs, tf, psc,
                                          d_ctr2=d2r)
            res[f"sampled G={g} N={n} transform={tf}"] = \
                _bits(a[0], b[0]) and _bits(a[1], b[1])
        _flat_bitwise(other, er, dr, d2r, ixs, g, n, res)
        del e, d, d2, er, dr, d2r, ixs
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    times = {}
    e, _e, d, d2, ixs = cs._sampled_case(cs.GENES, cs.CELLS, cs.CELLS,
                                         cs.NN_SAMPLED, 7, torch.int32)
    order = _locality(np.random.RandomState(7).rand(cs.CELLS, 2))
    times["uniform"] = _time_flat(other, "uniform", e, d, d2, ixs, order, 1,
                                  1e-10)
    del e, _e, d, d2, ixs
    torch.cuda.empty_cache()
    e, d, d2, ixs, order, tf, psc = _pipeline_indices()
    times["pipeline"] = _time_flat(other, "pipeline", e, d, d2, ixs, order,
                                   _TRANSFORMS[tf], psc)
    for k, v in times.items():
        res[f"flat timing runs bitwise ({k})"] = v.pop("bitwise")
    torch.cuda.empty_cache()
    ring = _ring_calls(pkg, e, d, d2, ixs, order, tf, psc)
    res["ring calls bitwise"] = ring.pop("bitwise")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()
    print(json.dumps({"card": torch.cuda.get_device_name(0), "smi": smi,
                      "bitwise": res, "flat_times": times,
                      "ring_calls": ring}))
    if not all(res.values()):
        sys.exit(f"outputs differ: {[k for k, v in res.items() if not v]}")
    return res


if __name__ == "__main__":
    if len(sys.argv) != 2:
        sys.exit("usage: python3 tools/kernels_against_checkout.py CHECKOUT")
    main(sys.argv[1])
