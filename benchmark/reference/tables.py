"""The reference's domains of a configuration, kept on disk in the
checkout's cache once built (they are a function of the configuration
and of the reference's own sources alone)."""

from __future__ import annotations

import glob
import hashlib
import json
import os
from typing import List

import numpy as np

from .domain import Faces, Family, RefDomain, build_domain
from .fas import levels

HERE = os.path.dirname(os.path.abspath(__file__))


def _key(cfg: dict, geometry: List[str], n_levels: int) -> str:
    h = hashlib.sha256(json.dumps(
        [cfg["case"], {k: cfg[k] for k in geometry}, n_levels],
        sort_keys=True).encode())
    for f in sorted(glob.glob(os.path.join(HERE, "**", "*.py"),
                              recursive=True)
                    + glob.glob(os.path.join(HERE, "data", "*"))):
        with open(f, "rb") as fh:
            h.update(fh.read())
    return h.hexdigest()[:16]


def _save(path: str, doms: List[RefDomain]) -> None:
    arr = {}
    for i, d in enumerate(doms):
        p = f"l{i}_"
        arr[p + "centers"], arr[p + "widths"] = d.centers, d.widths
        arr[p + "inside"] = d.inside
        for k, fc in enumerate(d.faces):
            for a in ("owner", "neighbor", "right", "left"):
                arr[f"{p}f{k}_{a}"] = getattr(fc, a)
        arr[p + "families"] = np.array(list(d.families))
        for name, fm in d.families.items():
            for a in ("ghosts", "normals", "eta", "idx", "w"):
                arr[f"{p}{name}_{a}"] = getattr(fm, a)
    tmp = f"{path}.{os.getpid()}.npz"
    np.savez(tmp, n=len(doms), **arr)
    os.replace(tmp, path)


def _load(path: str) -> List[RefDomain]:
    z = np.load(path)
    doms = []
    for i in range(int(z["n"])):
        p = f"l{i}_"
        nd = z[p + "centers"].shape[1]
        faces = [Faces(*(z[f"{p}f{k}_{a}"] for a in
                         ("owner", "neighbor", "right", "left")))
                 for k in range(nd)]
        fams = {str(n): Family(*(z[f"{p}{n}_{a}"] for a in
                                 ("ghosts", "normals", "eta", "idx", "w")))
                for n in z[p + "families"]}
        doms.append(RefDomain(None, z[p + "centers"], z[p + "widths"],
                              faces, fams, z[p + "inside"]))
    return doms


def domains(cfg: dict, case, n_levels: int, cache: str) -> List[RefDomain]:
    """The fine domain of ``cfg`` (``case``: its module of
    `reference.cases`) and ``n_levels - 1`` coarse levels, from the cache
    directory ``cache`` where they were built before."""
    path = os.path.join(cache, f"{cfg['case']}-"
                        f"{_key(cfg, case.GEOMETRY, n_levels)}.npz")
    if os.path.exists(path):
        return _load(path)
    msh, stl, fams = case.geometry(cfg)
    doms = levels(build_domain(msh, stl, fams), stl, fams, n_levels)
    os.makedirs(cache, exist_ok=True)
    _save(path, doms)
    return doms
