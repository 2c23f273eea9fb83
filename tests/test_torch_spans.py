"""The port's spans (utils/profiling.py: span, spanned, trace,
span_ranges, recorded) on the CPU.

With no profiler a span constructs nothing of torch's, on any thread,
and records nothing; under one, recorded() holds each span as it closed.
Under a profile, a tiny session of the tutorial's calls (normalize ->
grid, the benchmark's stages) holds each span of the catalogue that runs
on the calling thread, inside the call that opens it, and no vtt.* name
outside the catalogue; trace() also holds the sampled transition's
worker spans, on their own threads; the full mode holds its host round
trips, and its control's plan on a worker beside the embedding kNN, with
no upload of the permuted rows; bench_common.transition_split reads a call's split from them; a
profiled session gives the same outputs, bitwise. prepare_markov and
run_markov open exactly the Markov spans, and diffusion.power_steps
counts the steps' calls, steps and bytes."""
import contextlib
import threading

import numpy as np
import pytest
import torch

from velocyto_tpu_torch import analysis, bench_common
from velocyto_tpu_torch.utils import profiling

CPU = torch.device("cpu")
CELLS, GENES = 300, 40

# every span of the port, by name; upload.<attribute> and
# build.<library> are families
CATALOGUE = {
    "normalize.S", "normalize.U",
    "pca.center", "pca.gram", "pca.eigh", "pca.project", "pca.mean",
    "knn.candidates", "knn.rescore", "knn.hub_order", "knn.balance",
    "knn.smooth", "gammas", "velocity",
    "transition.inputs", "transition.embedding_knn",
    "transition.locality_order", "transition.wait.control",
    "transition.wait.chunk", "transition.wait.replay", "transition.chunk",
    "transition.replay", "transition.replay.upload",
    "transition.control.plan", "transition.control", "transition.cor",
    "shift.gather", "shift.softmax", "shift.project", "shift.scaling",
    "grid", "markov.tp", "markov.matrix", "markov.steps",
    "ring.upload", "ring.plan", "ring.schedule", "ring.launches",
    "ring.gather"}
FAMILIES = ("upload.", "build.")

# the spans each stage of a sampled session opens on the calling thread
SAMPLED = {
    "normalize": ["normalize.S", "normalize.U"],
    "pca": ["pca.center", "pca.gram", "pca.eigh", "pca.project",
            "pca.mean"],
    "knn_imputation": ["knn.candidates", "knn.rescore", "knn.hub_order",
                       "knn.balance", "knn.smooth", "upload.S",
                       "upload.U"],
    "fit_gammas": ["gammas"],
    "velocity": ["velocity"],
    "transition": ["transition.inputs", "transition.embedding_knn",
                   "transition.locality_order", "transition.wait.control",
                   "transition.wait.chunk", "transition.chunk",
                   "transition.wait.replay", "knn.candidates",
                   "knn.rescore"],
    "embedding_shift": ["shift.softmax", "shift.project"],
    "grid_arrows": ["grid"],
}
FULL_TRANSITION = ["transition.inputs", "transition.embedding_knn",
                   "transition.control", "transition.cor"]
FULL_SHIFT = ["shift.gather", "shift.softmax", "shift.project"]
MARKOV = ["markov.tp", "markov.matrix", "markov.steps"]


def _loom(seed=0):
    """A loom of rank-3 Poisson counts, as the loom reader leaves it."""
    rng = np.random.RandomState(seed)
    rate = rng.gamma(2.0, 1.0, (GENES, 3)) @ rng.gamma(2.0, 1.0, (3, CELLS))
    v = analysis.VelocytoLoom.__new__(analysis.VelocytoLoom)
    v.device, v.mesh = CPU, None
    v.S = rng.poisson(rate).astype(np.float64)
    v.U = rng.poisson(0.4 * rate).astype(np.float64)
    v.A = np.zeros_like(v.S)
    v.ca = {"CellID": np.array([f"c{i}" for i in range(CELLS)])}
    v.ra = {"Gene": np.array([f"g{i}" for i in range(GENES)])}
    v.initial_cell_size = v.S.sum(0)
    v.initial_Ucell_size = v.U.sum(0)
    return v


def _stages(knn_random):
    def transition(v):
        v.ts = np.ascontiguousarray(v.pcs[:, :2])
        v.estimate_transition_prob(
            hidim="Sx_sz", embed="ts", transform="sqrt", psc=1e-10,
            knn_random=knn_random, n_neighbors=50, sampled_fraction=0.5,
            calculate_randomized=True, random_seed=15071990)

    def velocity(v):
        v.predict_U()
        v.calculate_velocity()
        v.calculate_shift(assumption="constant_velocity", delta_t=1)
        v.extrapolate_cell_at_t(delta_t=1)
    return [
        ("normalize", lambda v: v.normalize("both")),
        ("pca", lambda v: v.perform_PCA(which="S_norm", n_components=10)),
        ("knn_imputation", lambda v: v.knn_imputation(
            k=10, balanced=True, b_sight=30, b_maxl=15)),
        ("fit_gammas", lambda v: v.fit_gammas()),
        ("velocity", velocity),
        ("transition", transition),
        ("embedding_shift", lambda v: v.calculate_embedding_shift(
            sigma_corr=0.05, expression_scaling=False)),
        ("grid_arrows", lambda v: v.calculate_grid_arrows(
            smooth=0.8, steps=(10, 10), n_neighbors=20)),
    ]


def _session(knn_random, profile):
    """(loom, profile or None) of one session; each stage in a host
    range "stage:<name>"."""
    v = _loom()
    with (profile() if profile else contextlib.nullcontext()) as prof:
        for name, run in _stages(knn_random):
            with torch.profiler.record_function("stage:" + name):
                run(v)
    return v, (prof if profile else None)


def _default_profile():
    """The benchmark's profile: the calling thread only."""
    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])


def _ranges(prof, prefix):
    """{name: [(start, end, thread)]} of the profile's host ranges whose
    name starts with prefix, the prefix taken off."""
    out = {}
    for e in prof.events():
        if e.name.startswith(prefix) and \
                e.device_type == torch.autograd.DeviceType.CPU:
            out.setdefault(e.name[len(prefix):], []).append(
                (e.time_range.start, e.time_range.end, e.thread))
    return out


def _inside(r, outer):
    return any(s <= r[0] and r[1] <= e and t == r[2] for s, e, t in outer)


@pytest.fixture(scope="module")
def sampled():
    v, prof = _session(True, _default_profile)
    return v, _ranges(prof, "stage:"), _ranges(prof, "vtt.")


@pytest.fixture(scope="module")
def full():
    v, prof = _session(False, _default_profile)
    return v, _ranges(prof, "stage:"), _ranges(prof, "vtt.")


class _Counting:
    """Stands in for torch.profiler.record_function and counts its
    constructions."""
    made = 0

    def __init__(self, name):
        type(self).made += 1


@pytest.mark.parametrize("where", ["caller", "worker"])
def test_no_profiler_no_record_function(where, monkeypatch):
    monkeypatch.setattr(torch.profiler, "record_function", _Counting)
    _Counting.made = 0
    seen = []

    @profiling.spanned("decorated")
    def work():
        with profiling.span("a"), profiling.span("b"):
            seen.append(profiling.span("c"))
    if where == "worker":
        t = threading.Thread(target=work)
        t.start()
        t.join()
    else:
        work()
    assert _Counting.made == 0
    assert seen == [profiling._OFF]


def test_a_worker_reads_the_profile_as_the_caller_does(monkeypatch):
    """Under a profile taken on another thread, a worker's span is a
    record_function (torch's thread-local flag reads False there)."""
    monkeypatch.setattr(torch.profiler, "record_function", _Counting)
    got = []
    with _default_profile():
        t = threading.Thread(target=lambda: got.append(
            profiling.span("x")))
        t.start()
        t.join()
    assert len(got) == 1 and isinstance(got[0].range, _Counting)


def test_recorded_holds_each_span_closed_under_a_profile():
    with profiling.span("before"):
        pass
    with _default_profile():
        with profiling.span("outer"):
            with profiling.span("inner"):
                pass
            t = threading.Thread(target=lambda: profiling.span(
                "worker").__enter__().__exit__(None, None, None))
            t.start()
            t.join()
    with profiling.span("after"):
        pass
    got = profiling.recorded()[-3:]
    assert [n for n, _, _, _ in got] == ["inner", "worker", "outer"]
    assert {"before", "after"}.isdisjoint(n for n, _, _, _ in
                                          profiling.recorded())
    me = threading.get_ident()
    assert [th == me for _, th, _, _ in got] == [True, False, True]
    (_, _, s_in, e_in), (_, _, s_w, e_w), (_, _, s_out, e_out) = got
    assert s_out <= s_in <= e_in <= s_w <= e_w <= e_out


@pytest.mark.parametrize("stage", list(SAMPLED))
def test_sampled_session_spans_nest_in_their_call(stage, sampled):
    _v, stages, spans = sampled
    for name in SAMPLED[stage]:
        assert name in spans, (stage, name, sorted(spans))
        assert any(_inside(r, stages[stage]) for r in spans[name]), \
            (stage, name)
    for name in SAMPLED[stage]:
        if stage == "transition" and name.startswith("knn."):
            # the embedding's kNN runs the search inside its own span
            within = [r for r in spans[name] if _inside(r, stages[stage])]
            assert within and all(
                _inside(r, spans["transition.embedding_knn"])
                for r in within)


def test_the_device_route_opens_the_normalize_and_pca_spans():
    """normalize and PCA on the device (no host view of normalize built,
    one Gram by the torch route): normalize's spans open in its call and
    again around each device copy of a view, with the upload of its raw
    counts inside, in PCA (S_norm) and in the smoothing (S_sz, U_sz);
    PCA's spans all open in its call; no view is uploaded."""
    from velocyto_tpu_torch.ops import pca as opca
    v = _loom()
    views0, grams0 = analysis.normalize_host_views, opca.pca_torch_grams
    with _default_profile() as prof:
        for name, run in _stages(True)[:3]:
            with torch.profiler.record_function("stage:" + name):
                run(v)
    assert (analysis.normalize_host_views - views0,
            opca.pca_torch_grams - grams0) == (0, 1)
    stages, spans = _ranges(prof, "stage:"), _ranges(prof, "vtt.")
    for name in SAMPLED["normalize"] + SAMPLED["pca"]:
        assert any(_inside(r, stages["normalize" if name.startswith(
            "normalize.") else "pca"]) for r in spans[name]), name
    built = {"pca": ["normalize.S"], "knn_imputation": ["normalize.S",
                                                        "normalize.U"]}
    for stage, names in built.items():
        for name in names:
            outer = [r for r in spans[name] if _inside(r, stages[stage])]
            assert outer, (stage, name)
            upload = "upload." + name[-1]
            assert any(_inside(r, outer) for r in spans[upload]), \
                (stage, upload)
    assert not [n for n in spans if n.startswith("upload.")
                and n not in ("upload.S", "upload.U")]


def test_sampled_session_names_only_the_catalogue(sampled):
    _v, _stages_, spans = sampled
    outside = [n for n in spans
               if n not in CATALOGUE and not n.startswith(FAMILIES)]
    assert outside == []
    # the benchmark's profile holds the calling thread alone
    assert {t for rs in spans.values() for _, _, t in rs} == \
        {spans["gammas"][0][2]}
    assert len(spans["transition.chunk"]) == analysis.SAMPLER_CHUNKS
    assert len(spans["transition.wait.chunk"]) == \
        analysis.SAMPLER_CHUNKS + 1


def test_trace_holds_the_workers_spans():
    v = _loom()
    for name, run in _stages(True)[:5]:
        run(v)
    with profiling.trace() as prof:
        _stages(True)[5][1](v)
    spans = _ranges(prof, "vtt.")
    caller = {t for _, _, t in spans["transition.wait.chunk"]}
    assert len(caller) == 1
    for name in ("transition.replay", "transition.control.plan"):
        assert name in spans, sorted(spans)
        assert {t for _, _, t in spans[name]}.isdisjoint(caller), name


def test_trace_holds_the_full_controls_plan_beside_the_knn():
    """The full mode's control is drawn on a worker that starts before
    the calling thread's embedding kNN ends."""
    v = _loom()
    for name, run in _stages(False)[:5]:
        run(v)
    with profiling.trace() as prof:
        _stages(False)[5][1](v)
    spans = _ranges(prof, "vtt.")
    (knn,) = spans["transition.embedding_knn"]
    (plan,) = spans["transition.control.plan"]
    assert plan[2] != knn[2]
    assert plan[0] < knn[1]
    assert {t for _, _, t in spans["transition.control"]} == {knn[2]}


def test_transition_split_reads_the_spans():
    v = _loom()
    for name, run in _stages(True)[:5]:
        run(v)
    with profiling.trace() as prof:
        with torch.profiler.record_function("call"):
            _stages(True)[5][1](v)
    split = bench_common.transition_split(prof, "call")
    assert split["chunks"] == analysis.SAMPLER_CHUNKS
    assert 0.0 < split["replay_s"] < split["call_s"]
    assert 0.0 < split["main_busy_s"] <= split["call_s"]
    assert 0.0 <= split["tail_s"] < split["call_s"]
    seconds = profiling.span_seconds(prof)
    assert seconds["transition.chunk"][0] == analysis.SAMPLER_CHUNKS
    assert seconds["transition.replay"][1] == pytest.approx(
        split["replay_s"])


def test_full_session_holds_its_host_round_trips(full):
    _v, stages, spans = full
    for names, stage in ((FULL_TRANSITION, "transition"),
                         (FULL_SHIFT, "embedding_shift")):
        for name in names:
            assert name in spans, (name, sorted(spans))
            assert all(_inside(r, stages[stage]) for r in spans[name]), name
    # the control is permuted on the device: nothing uploads it
    assert "upload.delta_S_rndm" not in spans
    # what is left of the control on the calling thread (the join, the
    # control's transform) is one span, with no span in it
    (control,) = spans["transition.control"]
    assert control[2] == stages["transition"][0][2]
    nested = [n for n, rs in spans.items() for r in rs
              if r != control and _inside(r, [control])]
    assert nested == []
    outside = [n for n in spans
               if n not in CATALOGUE and not n.startswith(FAMILIES)]
    assert outside == []
    assert "transition.replay" not in spans


@pytest.mark.parametrize("mode", ["sampled", "full"])
def test_spans_change_no_output(mode, sampled, full):
    profiled = sampled[0] if mode == "sampled" else full[0]
    plain, _ = _session(mode == "sampled", None)
    for name in ("pcs", "gammas", "delta_embedding", "delta_embedding_random",
                 "flow"):
        np.testing.assert_array_equal(getattr(profiled, name),
                                      getattr(plain, name), err_msg=name)


@pytest.mark.parametrize("direction", ["forward", "backwards"])
def test_markov_session_names_exactly_its_spans(direction, sampled):
    """prepare_markov + run_markov on the sampled session open
    markov.tp inside markov's first call, markov.matrix after it, and
    markov.steps in run_markov, each once, and no other span."""
    v = sampled[0]
    with _default_profile() as prof:
        with torch.profiler.record_function("stage:prepare"):
            v.prepare_markov(sigma_D=0.5, sigma_W=0.25, direction=direction)
        with torch.profiler.record_function("stage:run"):
            v.run_markov(n_steps=20)
    stages, spans = _ranges(prof, "stage:"), _ranges(prof, "vtt.")
    assert sorted(spans) == sorted(MARKOV)
    assert all(len(rs) == 1 for rs in spans.values())
    for name in MARKOV[:2]:
        assert _inside(spans[name][0], stages["prepare"]), name
    assert _inside(spans["markov.steps"][0], stages["run"])
    (tp,), (matrix,) = spans["markov.tp"], spans["markov.matrix"]
    assert tp[1] <= matrix[0]


def test_power_steps_counts_calls_steps_and_bytes():
    from velocyto_tpu_torch import diffusion
    n = 100                                    # 2 blocks of 64 rows
    tr = np.full((n, n), 1.0 / n)
    before = dict(diffusion.power_steps)
    x = analysis.Diffusion(CPU).diffuse(np.ones(n), tr, n_steps=7,
                                        mode="time_evolution")
    analysis.Diffusion(CPU).diffuse(np.ones(n), tr, n_steps=3,
                                    mode="path_integral")
    analysis.Diffusion(CPU).diffuse(np.ones(n), tr, n_steps=3,
                                    mode="map_trajectory")
    got = {k: diffusion.power_steps[k] - before[k] for k in before}
    assert got == {"calls": 2, "steps": 10, "bytes": 10 * 128 * n * 4}
    np.testing.assert_allclose(x[0], 1.0 / n, rtol=1e-6)
