"""What the harness and the reference load: nothing whose top-level
name is ``jax``, ``jaxlib``, ``flax`` or ``ibx`` (compared whole), and
the reference nothing of the program (``ibx_torch``)."""

import json
import os
import subprocess
import sys

from small_checkout import BENCH, ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "ibx"}


def _top_names(code: str):
    r = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json\n"
         "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=ROOT, capture_output=True, text=True, check=True,
        env=dict(os.environ, PYTHONPATH=""))
    return set(json.loads(r.stdout.strip().splitlines()[-1]))


PATHS = f"import sys; sys.path[:0] = [{ROOT!r}, {BENCH!r}]\n"


def test_the_harness_loads_no_jax():
    names = _top_names(PATHS + """
import glob, os, run, harness
for kind in ("runners", "metrics", "roofline"):
    for f in glob.glob(os.path.join(harness.HERE, kind, "*.py")):
        harness.module(kind, os.path.basename(f)[:-3])
import ibx_torch.cases, ibx_torch.solve
""")
    assert not names & FORBIDDEN, names & FORBIDDEN
    assert "ibx_torch" in names


def test_the_reference_loads_nothing_of_the_program():
    names = _top_names(PATHS + """
import glob, importlib, os
for f in glob.glob(os.path.join(%r, "reference", "**", "*.py"),
                   recursive=True):
    rel = os.path.relpath(f, %r)[:-3].replace(os.sep, ".")
    importlib.import_module(rel.removesuffix(".__init__"))
""" % (BENCH, BENCH))
    assert not names & (FORBIDDEN | {"ibx_torch"}), names
    assert "reference" in names
