"""A small checkout of the benchmark, whose cells run on the CPU in
seconds, and one run of a cell through the harness's ``main``."""

import json
import os
import shutil
import sys

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
for _p in (ROOT, BENCH):
    if _p not in sys.path:
        sys.path.insert(0, _p)

# the small meshes of each configuration: cells, blocks and the sizes
SMALL = {
    "rae2822": ({"wall_h": 0.08, "feature_h": 0.04}, 53248, 208),
    "sphere3d": ({"wall_h": 0.25, "block_size": 8}, 32768, 64),
}
# a traffic mix's work cut to a few steps or iterations
SMALL_TRAFFIC = {"chunk_steps": 2, "n_iter": 2, "sample_span": 2,
                 "settle": {"least_s": 0, "most_s": 0, "drop": 0.04,
                            "after_s": 0}, "trace_chunks": 1, "trace_calls": 1}


def make_small_root(dest: str) -> str:
    """A checkout at ``dest`` holding ``BENCHMARK.json`` and the
    benchmark's data and readers, every configuration on its small mesh
    and every traffic mix cut to a few steps."""
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        sp = json.load(f)
    bdir = os.path.join(dest, sp["paths"][0])
    for sub in ("runners", "metrics", "roofline", "limits", "traffic"):
        shutil.copytree(os.path.join(BENCH, sub), os.path.join(bdir, sub))
    os.makedirs(os.path.join(bdir, "configs"))
    for c in sp["configs"]:
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        sizes, cells, blocks = SMALL[cfg["case"]]
        cfg["build"].update(sizes)
        cfg.update(cells=cells, blocks=blocks)
        with open(os.path.join(dest, c["file"]), "w") as f:
            json.dump(cfg, f)
    tdir = os.path.join(bdir, "traffic")
    for name in os.listdir(tdir):
        p = os.path.join(tdir, name)
        with open(p) as f:
            tr = json.load(f)
        tr.update({k: v for k, v in SMALL_TRAFFIC.items() if k in tr})
        with open(p, "w") as f:
            json.dump(tr, f)
    with open(os.path.join(dest, "BENCHMARK.json"), "w") as f:
        json.dump(sp, f)
    return dest


def run_cell(root, workload, *, seed=2 ** 31 + 12345, seconds=0.01,
             trace=0, device="cpu", capsys=None):
    """One run of ``workload`` through the harness's ``main``; (exit
    code, result line or None)."""
    import run
    code = run.main(["--workload", workload, "--seed", str(seed),
                     "--seconds", str(seconds), "--trace", str(trace)],
                    root=root, device=device)
    line = None
    if capsys is not None:
        out = capsys.readouterr().out.strip().splitlines()
        line = json.loads(out[-1]) if out else None
    return code, line
