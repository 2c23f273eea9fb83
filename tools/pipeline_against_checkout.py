"""The default pipeline's wall time, its transition call and the heuristic
session in this checkout against another checkout of the port, in turns
on one card.

First each checkout builds its kernels and its host sampler, untimed.
Then each turn runs, in fresh processes and from the root of one
checkout, python3 -m velocyto_tpu_torch.bench_pipeline (20,000 x 2,000,
seed 0, default mode; VTPU_BENCH_PIPE_REPS runs, run 0 a warm-up),
python3 -m velocyto_tpu_torch.bench_attr transition (the whole
estimate_transition_prob call at 20,000 x 2,000, nn 3,500), and
chip_smoke.py's heuristic session (20,000 cells x 12,000 raw genes,
heuristic_phase, its checks included) twice in one process, the first a
warm-up.  The turns go other, this, this, other (TURNS rounds of that),
so a drift of the host or the card over the call shows as a difference
between the two turns of one checkout.  Use it to show whether a change moved the wall time of
paths whose code it did not touch:

    git archive <commit> | tar -x -C _archive/other
    python3 tools/pipeline_against_checkout.py _archive/other

Prints each turn's numbers as it ends, then one JSON line: per turn the
checkout, the pipeline's median of its clean runs with min and max, the
run closest to the median's transition stage, the host dgemm and device
probes around each run, bench_attr's whole call, its replay, its
calling thread's busy time and its idle share, and the second heuristic
session's total and stages.  Run from the repo root, on a machine with
a card and nvcc.
"""
import json
import os
import statistics
import subprocess
import sys
from pathlib import Path

THIS = Path(__file__).resolve().parent.parent
REPS = int(os.environ.get("VTPU_BENCH_PIPE_REPS", 4))
TURNS = int(os.environ.get("VTPU_PAIR_TURNS", 1))


def _json_line(cmd, cwd):
    """Run cmd in cwd; its last standard-output line, parsed."""
    env = {**os.environ, "VTPU_BENCH_PIPE_REPS": str(REPS)}
    out = subprocess.run(cmd, cwd=cwd, env=env, capture_output=True,
                         text=True, timeout=900)
    if out.returncode != 0:
        sys.stderr.write(out.stdout[-4000:] + out.stderr[-4000:])
        raise SystemExit(f"{' '.join(cmd)} in {cwd}: rc {out.returncode}")
    return json.loads(out.stdout.strip().splitlines()[-1])


PREPARE = ("from velocyto_tpu_torch import kernels, native\n"
           "kernels.build()\n"
           "native.build()\n"
           "print('{}')\n")
HEURISTIC = ("import json\n"
             "import chip_smoke as cs\n"
             "smi = cs.device_phase()[1]\n"
             "cs.heuristic_phase(smi)\n"
             "stages, total, _l, _p = cs.heuristic_phase(smi)\n"
             "print(json.dumps({'total': total, 'stages': stages}))\n")


def turn(label, root):
    pipe = _json_line([sys.executable, "-m",
                       "velocyto_tpu_torch.bench_pipeline"], root)
    attr = _json_line([sys.executable, "-m", "velocyto_tpu_torch.bench_attr",
                       "transition"], root)["transition_prob_substages"]
    heur = _json_line([sys.executable, "-c", HEURISTIC], root)
    stage = next(k for k in pipe["stages"] if k.startswith("transition"))
    measured = [r for r in pipe["runs"] if not r["warmup"]]
    rec = {"checkout": label,
           "pipeline_median_s": pipe["value"],
           "pipeline_min_s": pipe["min_total"],
           "pipeline_max_s": pipe["max_total"],
           "n_clean": pipe["n_clean"],
           "transition_stage_s": pipe["stages"][stage],
           "transition_stage_median_s": statistics.median(
               r["stages"][stage] for r in measured),
           "host_probe_ms": [r["host_probe_ms"] for r in pipe["runs"]],
           "device_probe_ms": [r["probe_ms"] for r in pipe["runs"]],
           "attr_whole_call_s": attr["transition_prob(whole)"],
           "attr_replay_in_call_s": attr["replay(in_call)"],
           "attr_main_busy_s": attr["main_busy(in_call)"],
           "attr_idle_share": attr["idle_share(whole)"],
           "heuristic_s": heur["total"],
           "heuristic_stages_s": heur["stages"],
           "card": pipe["card"]}
    print(f"# {label}: pipeline {rec['pipeline_median_s']!r} s "
          f"({rec['pipeline_min_s']!r}-{rec['pipeline_max_s']!r}), "
          f"transition stage {rec['transition_stage_median_s']!r} s, "
          f"bench_attr call {rec['attr_whole_call_s']!r} s "
          f"(replay {rec['attr_replay_in_call_s']!r}), heuristic session "
          f"{rec['heuristic_s']!r} s {rec['heuristic_stages_s']}, host probes "
          f"{rec['host_probe_ms']}", flush=True)
    return rec


def main(other):
    other = Path(other).resolve()
    for root in (other, THIS):
        _json_line([sys.executable, "-c", PREPARE], root)
    turns = []
    for _ in range(TURNS):
        for label, root in (("other", other), ("this", THIS),
                            ("this", THIS), ("other", other)):
            turns.append(turn(label, root))
    print(json.dumps({"reps": REPS, "turns": turns}))


if __name__ == "__main__":
    main(sys.argv[1])
