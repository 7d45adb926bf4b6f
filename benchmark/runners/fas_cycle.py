"""The FAS runner: calls of a captured FAS cycle back to back for the
whole window.

Entry: ``ibx_torch.solve.FasEuler`` over the gather march of
``ibx_torch.cases.build_<case>(**build)`` (``use_blocks=False``), called
as ``cycle(Q, n_iter=..., rtol=...)``; on the card each level's pieces
are captured CUDA graphs and the host reads the stop rule before each
smoothing iteration. The window counts the calls completed over all of
its time. Compared with the reference: the first call (from the seeded
start), one call drawn from the seed, and the last; each call's state
change and its residual reduction ratio.
"""

from __future__ import annotations

import importlib
import time

import numpy as np
import torch

import harness
from reference.euler import Fluid
from reference.fas import Fas
from reference.tables import domains


def fas_solver(case, max_levels, smoother, cfl):
    """`FasEuler` over ``case.dom``: the farfield and wall families one
    after the other through `Domain.impose_bc`, the cells inside the
    airfoil frozen on every level (the port's documented FAS recipe)."""
    from ibx_torch.cases.rae2822 import RAE_DAT
    from ibx_torch.geometry import load_surface, merge_points
    from ibx_torch.geometry.inside import points_inside
    from ibx_torch.physics import apply_flow_bc, flow_bc
    from ibx_torch.solve import FasEuler

    stl = merge_points(load_surface(RAE_DAT))
    dev = case.P0.device
    P_inf = np.asarray(case.P_inf, np.float32)
    far = flow_bc(case.fluid, P_inf, device=dev)
    wall = flow_bc(case.fluid, [float(P_inf[0]), float(P_inf[1]), 0.0],
                   normal_flow=True, device=dev)

    def make_bcs(d):
        def apply_bcs(P):
            P = d.impose_bc(
                "farfield", lambda b, Pi: apply_flow_bc(far, Pi, b.normals),
                P)
            return d.impose_bc(
                "wall", lambda b, Pi: apply_flow_bc(wall, Pi, b.normals), P)
        return apply_bcs

    return FasEuler(case.dom, case.fluid, make_bcs, max_levels=max_levels,
                    cfl=cfl, smoother=smoother,
                    inside_fn=lambda c: points_inside(stl, c))


class Run:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        self.cfg, self.tr, self.seed, self.device = cfg, traffic, seed, device
        self.params = dict(cfg["build"], **traffic.get("build", {}))
        self.flow = dict(cfg, **self.params)
        self.refcase = importlib.import_module("reference.cases." + cfg["case"])
        self.kw = dict(n_iter=int(traffic["n_iter"]),
                       rtol=float(traffic["rtol"]))
        self.keep = {}

    def setup(self) -> None:
        import ibx_torch.cases as cases
        build = getattr(cases, "build_" + self.cfg["case"])
        self.case = build(device=self.device, **self.params)
        n = self.case.dom.ncells
        if n != self.cfg["cells"]:
            raise RuntimeError(f"{n} cells, the configuration states "
                               f"{self.cfg['cells']}")
        t0 = time.perf_counter()
        self.fe = fas_solver(self.case, int(self.tr["max_levels"]),
                             self.tr["smoother"], float(self.tr["cfl"]))
        self.host_build_s = float(self.case.build_seconds) + (
            time.perf_counter() - t0)
        self.reseed(self.seed)
        # the first call builds the levels' tables and captures the cycle
        self.fe.cycle(self.Q0.clone(), **self.kw)
        harness.sync(self.device)

    def settle(self) -> dict:
        """The same call from the seeded start until the card has left
        its slow first phase (`harness.settle`), after set-up and before
        the window."""
        return harness.settle(lambda: self.fe.cycle(self.Q0, **self.kw),
                              self.device, **self.tr["settle"])

    def reseed(self, seed: int) -> None:
        """The seeded start state of ``seed``; nothing kept."""
        self.seed, self.keep = seed, {}
        self.P_start = harness.start_state(
            self.refcase.freestream(self.flow), self.cfg["cells"], seed,
            float(self.tr["amplitude"]), self.device)
        self.Q0 = self.fe.init_state(self.P_start)

    def _calls(self, seconds: float, n_max: int, sample: int) -> int:
        Q, n = self.Q0, 0
        t0 = time.perf_counter()
        while True:
            Qin = Q
            Q, ratio = self.fe.cycle(Qin, **self.kw)
            if n == 0:
                self.keep["start"] = (Qin, Q, ratio)
            if n == sample:
                self.keep["sample"] = (Qin, Q, ratio)
            n += 1
            if n >= n_max or time.perf_counter() - t0 >= seconds:
                break
        harness.sync(self.device)
        self.keep["end"] = (Qin, Q, ratio)
        return n

    def window(self, seconds: float) -> dict:
        sample = harness.seeded_index(self.seed, 1, int(self.tr["sample_span"]))
        harness.sync(self.device)
        t0 = time.perf_counter()
        n = self._calls(seconds, 1 << 62, sample)
        el = time.perf_counter() - t0
        self.attempted = n
        return {"solver_call_ms": el * 1e3 / n}

    def traced(self, path: str) -> dict:
        n = int(self.tr["trace_calls"])
        tr = harness.trace_stretch(lambda: self._calls(1e9, n, -1), path,
                                   self.device)
        self.attempted = n
        return {"trace": tr, "calls": n}

    def release(self) -> None:
        del self.fe, self.case

    def _reference(self, dtype):
        doms = domains(self.flow, self.refcase, int(self.tr["max_levels"]),
                       harness.CACHE + "/reference")
        return Fas(doms, self.refcase.freestream(self.flow), dtype=dtype,
                   device=self.device, cfl=float(self.tr["cfl"]), **self.kw)

    def readings(self, control: bool = False) -> dict:
        """Each kept call's state gap and the worst ratio gap to the
        float64 reference; with ``control`` also the bfloat16
        reference's in the program's place (``control.<name>``). The
        first call starts from the reference's own state of the seeded
        primitives."""
        ref = self._reference(torch.float64)
        ctl = self._reference(torch.bfloat16) if control else None
        out = {"ratio_gap": 0.0}
        if ctl is not None:
            out["control.ratio_gap"] = 0.0
        for name, (Qin, Qout, ratio) in self.keep.items():
            if name == "start":
                Qin = Fluid.to_state(ref.march[0].bcs(self.P_start.double()))
            R, r_ref, _ = ref.cycle(Qin)
            sides = [("", Qout, ratio)]
            if ctl is not None:
                sides.append(("control.",) + tuple(ctl.cycle(Qin)[:2]))
            for pre, Q, r in sides:
                out[pre + name + "_gap"] = harness.change_gap(Qin, Q, R)
                out[pre + "ratio_gap"] = max(out[pre + "ratio_gap"],
                                             harness.rel_gap(float(r),
                                                             float(r_ref)))
        return out
