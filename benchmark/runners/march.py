"""The march runner: a case's default pseudo-time march, captured and
replayed in chunks of ``chunk_steps`` steps for the whole window.

Entry: ``ibx_torch.cases.build_<case>(**build)`` and its ``march(P, n)``
(on the card a captured step replayed ``n`` times). The window counts
cells x steps completed over all of its time, which ends at a final
synchronize; at most four chunks are in flight, so the window ends within
four chunks of its length. Compared with the reference: the first chunk
(from the seeded start), one chunk drawn from the seed, and the last.
"""

from __future__ import annotations

import collections
import importlib
import time

import torch

import harness
from reference.euler import Euler
from reference.tables import domains


class Run:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        self.cfg, self.tr, self.seed, self.device = cfg, traffic, seed, device
        self.params = dict(cfg["build"], **traffic.get("build", {}))
        self.flow = dict(cfg, **self.params)
        self.refcase = importlib.import_module("reference.cases." + cfg["case"])
        self.chunk = int(traffic["chunk_steps"])
        self.keep = {}

    def setup(self) -> None:
        import ibx_torch.cases as cases
        build = getattr(cases, "build_" + self.cfg["case"])
        self.case = build(device=self.device, **self.params)
        n = self.case.dom.ncells
        if n != self.cfg["cells"]:
            raise RuntimeError(f"{n} cells, the configuration states "
                               f"{self.cfg['cells']}")
        self.host_build_s = float(self.case.build_seconds)
        self.reseed(self.seed)
        # the first chunk builds the kernels and captures the step
        self.case.march(self.P0.clone(), self.chunk)
        harness.sync(self.device)

    def settle(self) -> dict:
        """The same chunk from the seeded start until the card has left
        its slow first phase (`harness.settle`), after set-up and before
        the window."""
        return harness.settle(lambda: self.case.march(self.P0, self.chunk),
                              self.device, **self.tr["settle"])

    def reseed(self, seed: int) -> None:
        """The seeded start state of ``seed``; nothing kept."""
        self.seed, self.keep = seed, {}
        self.P0 = harness.start_state(
            self.refcase.freestream(self.flow), self.cfg["cells"], seed,
            float(self.tr["amplitude"]), self.device)

    def _chunks(self, seconds: float, n_max: int, sample: int) -> int:
        P, n, evs = self.P0, 0, collections.deque()
        t0 = time.perf_counter()
        while True:
            Pin = P
            P = self.case.march(Pin, self.chunk)
            if n == 0:
                self.keep["start"] = (Pin, P)
            if n == sample:
                self.keep["sample"] = (Pin, P)
            n += 1
            if self.device.type == "cuda":
                # at most four chunks in flight
                evs.append(torch.cuda.Event())
                evs[-1].record()
                if len(evs) > 4:
                    evs.popleft().synchronize()
            if n >= n_max or time.perf_counter() - t0 >= seconds:
                break
        harness.sync(self.device)
        self.keep["end"] = (Pin, P)
        return n

    def window(self, seconds: float) -> dict:
        sample = harness.seeded_index(self.seed, 1, int(self.tr["sample_span"]))
        harness.sync(self.device)
        t0 = time.perf_counter()
        n = self._chunks(seconds, 1 << 62, sample)
        el = time.perf_counter() - t0
        self.attempted = n
        steps = n * self.chunk
        return {"cell_updates_per_s": self.cfg["cells"] * steps / el}

    def traced(self, path: str) -> dict:
        n = int(self.tr["trace_chunks"])
        tr = harness.trace_stretch(lambda: self._chunks(1e9, n, -1), path,
                                   self.device)
        self.attempted = n
        return {"trace": tr, "steps": n * self.chunk}

    def release(self) -> None:
        del self.case

    def _reference(self, dtype):
        dom = domains(self.flow, self.refcase, 1, harness.CACHE + "/reference")
        return Euler(dom[0], self.refcase.freestream(self.flow), dtype=dtype,
                     device=self.device, cfl=float(self.params["cfl"]),
                     guarded=True)

    def readings(self, control: bool = False) -> dict:
        """Each kept chunk's gap to the float64 reference; with
        ``control`` also the bfloat16 reference's in the program's place
        (``control.<name>``)."""
        ref = self._reference(torch.float64)
        ctl = self._reference(torch.bfloat16) if control else None
        out = {}
        for name, (Pin, Pout) in self.keep.items():
            R = ref.march(Pin, self.chunk)
            out[name + "_gap"] = harness.change_gap(Pin, Pout, R)
            if ctl is not None:
                out["control." + name + "_gap"] = harness.change_gap(
                    Pin, ctl.march(Pin, self.chunk), R)
        return out
