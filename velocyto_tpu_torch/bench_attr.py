"""Sub-stage attribution of the port's two heaviest stages, on one CUDA
device.

    python3 -m velocyto_tpu_torch.bench_attr \
        [transition|knn50k|knn20k|both|all]

Port of the JAX package's bench_attr.py.  Splits
  - estimate_transition_prob(knn_random=True) at 20k cells x 2k genes,
    nn=3500, frac=0.5, randomized control, into the pieces the port's
    path runs: the embedding kNN, the sampler's replay (native, whole),
    the sampled-neighbour gather, the randomized control's permutation
    applied on the device (its plan drawn untimed, as the path draws it
    on a worker), the two displacement transforms, and the sampled
    colDeltaCor in locality order, once as a dual launch over all rows
    and once for the main field alone; then one whole
    estimate_transition_prob call, timed, and once more under
    torch.profiler (utils.profiling.trace) for the device's idle share
    over it and its split, read from the port's spans in that profile
    (bench_common.transition_split: the replay's own seconds in the call,
    on its thread; the calling thread's busy seconds; the tail from the
    replay's end to the call's end) (the path runs the rest beside the
    replay and consumes its rows chunk by chunk, so the whole is less
    than the sum);
  - the 50k balanced kNN into bench_knn50k's stages;
  - the same stages at the pipeline's operating point (20,000 x 50 PCs,
    sight 3000, k=500, maxl 1500), with the numpy host greedy loop timed
    beside them on the same candidates, copies included
    ("balance_loop(host)", left out of the sum): the kNN stage of one
    session with the balance on the card and with it on the host,
and prints a JSON sub-table for each ("both" runs the JAX script's two,
"all" the three).  Each sub-stage runs once untimed first,
then once timed, ending in torch.cuda.synchronize().  The device probe
runs before and after each section (a shared card runs identical work
several times slower in contended phases).

Keys renamed from the JAX script's, where the port's piece differs:
RENAMED below.  Raises without a CUDA device when run as a script; the
functions take device="cpu" for the tests (no probe, no idle share).
"""
import json
import sys
import time

import numpy as np
import torch

from .bench_common import (device_probe, host_window, idle_share,
                           require_card, sync, transition_split)
from .utils.profiling import trace

# the JAX script's keys -> the port's, where the port's piece differs
RENAMED = {"permute_rndm(sort)": "permute_rndm(device)",
           "corr_kernel_rndm": "corr_kernel_dual"}
# keys of the transition table that the JAX script has no counterpart of
ADDED = ("transition_prob(whole)", "replay(in_call)", "main_busy(in_call)",
         "tail(in_call)", "transition_prob(whole,profiled)",
         "idle_share(whole)")
# the whole call and its split: left out of the sum of the pieces
_WHOLE = ("transition_prob(whole", "replay(", "main_busy(", "tail(",
          "idle_share")


def timed(name, fn, out, device):
    """fn() once untimed, then once between two syncs; records the seconds
    under out[name] and returns fn's result."""
    fn()
    sync(device)
    t0 = time.perf_counter()
    r = fn()
    sync(device)
    dt = time.perf_counter() - t0
    out[name] = dt
    print(f"#   {name}: {dt:.3f}s", flush=True)
    return r


def _probe(device):
    return device_probe() if torch.device(device).type == "cuda" else None


def attr_transition(n=20000, g=2000, nn=3500, frac=0.5, device="cuda"):
    from . import native
    from .analysis import (VelocytoLoom, _corr_transform_dev,
                           _permute_apply_dev, _permute_rows_nsign_plan,
                           _sample_neighbors_dev)
    from .ops import knn_device as kd
    from .ops.coldeltacor import col_delta_cor_partial_compact, locality_order

    out = {}
    rng = np.random.RandomState(0)
    emb = rng.randn(n, 2).astype(np.float64) * 10
    Sx = torch.as_tensor(rng.gamma(2., 1., (g, n)).astype(np.float32),
                         device=device)
    dS = torch.as_tensor(rng.randn(g, n).astype(np.float32) * 0.1,
                         device=device)
    nn_k = min(nn + 1, n - 1)

    print("# transition_prob attribution", flush=True)
    p0 = _probe(device)
    print(f"#   probe_before: {p0}ms", flush=True)

    idx_dev = timed("embedding_knn", lambda: kd.knn_search_dev(
        emb, min(nn_k + 1, n), device=device)[1], out, device)
    p = np.linspace(0.5, 0.1, nn_k)
    p = p / p.sum()
    n_samp = int(frac * nn_k)
    samp = timed("rng_sampling(native)",
                 lambda: native.choice_noreplace_rows_state(
                     15071990, n, nn_k, n_samp, p)[0], out, device)
    neigh = timed("sample_gather(fused)", lambda: _sample_neighbors_dev(
        idx_dev, torch.as_tensor(samp, device=device)), out, device)

    perms, sign_bits = _permute_rows_nsign_plan(g, n)
    perms = torch.from_numpy(perms).to(device)
    sign_bits = torch.from_numpy(sign_bits).to(device)
    dS_r = timed("permute_rndm(device)", lambda: _permute_apply_dev(
        dS, perms, sign_bits), out, device)
    d_main = timed("transform_main", lambda: _corr_transform_dev(
        Sx, dS, 1.0, 1e-10, "sqrt"), out, device)
    d_rndm = timed("transform_rndm", lambda: _corr_transform_dev(
        Sx, dS_r, 1.0, 1e-10, "sqrt"), out, device)

    def order():
        return locality_order(torch.as_tensor(emb, device=device))
    timed("corr_kernel_main", lambda: col_delta_cor_partial_compact(
        Sx, d_main, neigh, "sqrt", 1e-10, order=order()), out, device)
    timed("corr_kernel_dual", lambda: col_delta_cor_partial_compact(
        Sx, d_main, neigh, "sqrt", 1e-10, dmat_random=d_rndm,
        order=order()), out, device)

    # the whole stage through the entry point, on the same inputs
    vlm = VelocytoLoom.__new__(VelocytoLoom)
    vlm.device = torch.device(device)
    vlm._set_dev("Sx_sz", Sx)
    vlm._set_dev("delta_S", dS)
    vlm.ts, vlm.used_delta_t = emb, 1.0

    def whole():
        vlm.estimate_transition_prob(
            hidim="Sx_sz", embed="ts", transform="sqrt", knn_random=True,
            n_neighbors=nn, sampled_fraction=frac, calculate_randomized=True)
    timed("transition_prob(whole)", whole, out, device)
    with trace() as prof:
        t0 = time.perf_counter()
        with torch.profiler.record_function("transition_prob(whole)"):
            whole()
            sync(device)
        out["transition_prob(whole,profiled)"] = time.perf_counter() - t0
    split = transition_split(prof, "transition_prob(whole)")
    for key, name in (("replay_s", "replay(in_call)"),
                      ("main_busy_s", "main_busy(in_call)"),
                      ("tail_s", "tail(in_call)")):
        out[name] = split[key]
        print(f"#   {name}: {split[key]!r}s", flush=True)
    if torch.device(device).type == "cuda":
        out["idle_share(whole)"] = idle_share(
            prof, *host_window(prof, "transition_prob(whole)"))
    else:
        out["idle_share(whole)"] = None      # no device: not measured
    print(f"#   idle_share(whole): {out['idle_share(whole)']}", flush=True)

    p1 = _probe(device)
    print(f"#   probe_after: {p1}ms", flush=True)
    out["probe_ms"] = [p0, p1]
    out["sum"] = sum(v for k, v in out.items() if isinstance(v, float)
                     and not k.startswith(_WHOLE))
    return out


def _attr_knn(label, n, d, k, sight, maxl, device, host_loop):
    from . import bench_knn50k

    x = bench_knn50k.points(n, d)
    x64 = torch.as_tensor(x.astype(np.float64), device=device)
    print(f"# {label} attribution (n={n}, sight={sight}, k={k})", flush=True)
    p0 = _probe(device)
    print(f"#   probe_before: {p0}ms", flush=True)
    bench_knn50k.run_once(x, x64, device, k, sight, maxl,      # untimed
                          host_loop=host_loop)
    _total, out, _graph = bench_knn50k.run_once(x, x64, device, k, sight,
                                                maxl, host_loop=host_loop)
    for name, dt in out.items():
        print(f"#   {name}: {dt:.3f}s", flush=True)
    p1 = _probe(device)
    print(f"#   probe_after: {p1}ms", flush=True)
    out["probe_ms"] = [p0, p1]
    out["sum"] = sum(v for key, v in out.items() if isinstance(v, float)
                     and key != "balance_loop(host)")
    return out


def attr_knn50k(n=50000, d=50, k=500, sight=3000, maxl=1500,
                device="cuda"):
    return _attr_knn("knn50k", n, d, k, sight, maxl, device, False)


def attr_knn20k(n=20000, d=50, k=500, sight=3000, maxl=1500,
                device="cuda"):
    return _attr_knn("knn20k", n, d, k, sight, maxl, device, True)


def main(which="all"):
    require_card()
    res = {"device": torch.cuda.get_device_name(0)}
    if which in ("all", "both", "transition"):
        res["transition_prob_substages"] = attr_transition()
    if which in ("all", "both", "knn50k"):
        res["knn_50k_substages"] = attr_knn50k()
    if which in ("all", "knn20k"):
        res["knn_20k_substages"] = attr_knn20k()
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "all")
