"""The RANS march runner: the RAE2822 RANS case's captured block march
(Navier-Stokes faces, Wray-Agarwal transport of Rt, wall functions),
replayed in chunks of ``chunk_steps`` steps for the whole window.

Entry: ``ibx_torch.cases.build_rae2822_rans(**build)`` and its
``march(P, Rt, n)`` (on the card a captured step replayed ``n`` times).
The start is the seeded freestream of `harness.start_state` and Rt_inf
times (1 + a n), n standard normal from the seed. The window counts
cells x steps completed over all of its time, which ends at a final
synchronize; at most four chunks are in flight. Compared with the float64
reference (`reference.rans`), the flow's four channels and Rt apart: the
first chunk, one drawn from the seed, and the last. ``traced`` records
the program's spans (the profiler off) before the profiler's stretch.
"""

from __future__ import annotations

import collections
import importlib
import time

import torch

import harness
import spans
from reference.rans import Rans, freestream_rt
from reference.tables import domains


class Run:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        self.cfg, self.tr, self.seed, self.device = cfg, traffic, seed, device
        self.params = dict(cfg["build"], **traffic.get("build", {}))
        self.flow = dict(cfg, **self.params)
        self.refcase = importlib.import_module("reference.cases." + cfg["case"])
        self.P_inf = self.refcase.freestream(self.flow)
        self.Re = float(self.params["reynolds"])
        self.Rt_inf = freestream_rt(self.P_inf, self.Re)
        self.chunk = int(traffic["chunk_steps"])
        self.keep = {}

    def setup(self) -> None:
        from ibx_torch.cases import build_rae2822_rans
        self.case = build_rae2822_rans(device=self.device, **self.params)
        n = self.case.dom.ncells
        if n != self.cfg["cells"]:
            raise RuntimeError(f"{n} cells, the configuration states "
                               f"{self.cfg['cells']}")
        self.host_build_s = float(self.case.build_seconds)
        self.reseed(self.seed)
        # the first chunk captures the step
        self.case.march(*self.X0, self.chunk)
        harness.sync(self.device)

    def settle(self) -> dict:
        """The same chunk from the seeded start until the card has left
        its slow first phase (`harness.settle`)."""
        return harness.settle(lambda: self.case.march(*self.X0, self.chunk),
                              self.device, **self.tr["settle"])

    def reseed(self, seed: int) -> None:
        """The seeded start (P, Rt) of ``seed``; nothing kept."""
        self.seed, self.keep = seed, {}
        amp, N = float(self.tr["amplitude"]), self.cfg["cells"]
        P0 = harness.start_state(self.P_inf, N, seed, amp, self.device)
        g = torch.Generator(device=self.device)
        g.manual_seed((int(seed) + 1) % (2 ** 63))
        n = torch.randn(N, generator=g, device=self.device,
                        dtype=torch.float32)
        self.X0 = (P0, self.Rt_inf * (1.0 + amp * n))

    def _chunks(self, seconds: float, n_max: int, sample: int) -> int:
        X, n, evs = self.X0, 0, collections.deque()
        t0 = time.perf_counter()
        while True:
            Xin = X
            X = self.case.march(*Xin, self.chunk)
            if n == 0:
                self.keep["start"] = (Xin, X)
            if n == sample:
                self.keep["sample"] = (Xin, X)
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
        self.keep["end"] = (Xin, X)
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
        """The program's spans over ``trace_chunks`` chunks (the traced
        step captured and the card settled first, the profiler off), then
        the profiler's stretch of as many."""
        from ibx_torch.utils import monitor
        n = int(self.tr["trace_chunks"])

        def unit(k):
            return self._chunks(1e9, k, -1)
        with monitor.tracing():
            unit(1)
        self.settle()
        rec = spans.stretch(unit, n, self.device)
        tr = harness.trace_stretch(lambda: unit(n), path, self.device)
        self.attempted = n
        return {"spans": rec, "trace": tr, "steps": n * self.chunk}

    def release(self) -> None:
        del self.case

    def _reference(self, dtype):
        dom = domains(self.flow, self.refcase, 1, harness.CACHE + "/reference")
        return Rans(dom[0], self.P_inf, reynolds=self.Re, dtype=dtype,
                    device=self.device, cfl=float(self.params["cfl"]),
                    wall_model=bool(self.params["wall_model"]))

    def readings(self, control: bool = False) -> dict:
        """Each kept chunk's gaps to the float64 reference, of the flow
        (``<chunk>_gap``) and of Rt (``<chunk>_rt_gap``); with ``control``
        also the bfloat16 reference's in the program's place
        (``control.<name>``)."""
        ref = self._reference(torch.float64)
        ctl = self._reference(torch.bfloat16) if control else None
        out = {}
        for name, ((P, Rt), (Pout, Rtout)) in self.keep.items():
            S0 = ref.state(P, Rt)
            R = ref.march(S0, self.chunk)
            got = {"": torch.cat([Pout, Rtout[:, None]], 1)}
            if ctl is not None:
                got["control."] = ctl.march(ctl.state(P, Rt), self.chunk)
            for tag, S in got.items():
                out[tag + name + "_gap"] = harness.change_gap(
                    S0[:, :-1], S[:, :-1], R[:, :-1])
                out[tag + name + "_rt_gap"] = harness.change_gap(
                    S0[:, -1:], S[:, -1:], R[:, -1:])
        return out
