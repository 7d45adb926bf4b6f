"""How far one ulp moves the point-implicit map at nd = 3, against how far
the card moves it from the CPU.

On the bs=8 sphere (wall_h=0.125, 147,456 cells), for four states (the
freestream P0, P0 after 5 and 20 steps, and the perturbed state of
chip_smoke.py's phase 3) and both limiters, prints the per-channel error
of ``g`` at Q_n and of its JVP along a seeded direction: the card against
the CPU, and the CPU against itself from the state moved by one ulp at
random in every cell. Where the pressure is uniform in a direction (the
freestream, the perturbed state along z) the JST sensor's 0/0 and the
limiter's ties sit at their kinks, so one ulp moves the JVP by O(1);
chip_smoke.py's phase 31 holds the card to the CPU on the developed flow
of 5 steps. Needs a CUDA device:

    python3 scripts/torch_pi3d_conditioning.py
"""

import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from ibx_torch.cases import build_sphere3d  # noqa: E402
from ibx_torch.solve import Linearization  # noqa: E402
from ibx_torch.solve.point_implicit_euler import newton_map  # noqa: E402


def main():
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    cg = build_sphere3d(wall_h=0.125, block_size=8, device=dev)
    cc = build_sphere3d(wall_h=0.125, block_size=8, device="cpu")
    act_g, act_c = cg.active3.reshape(-1), cc.active3.reshape(-1)
    states = {"P0": cg.P0, "P0 + 5 steps": cg.march(cg.P0, 5),
              "P0 + 20 steps": cg.march(cg.P0, 20),
              "perturbed (phase 3)": cs.perturbed(cg)}
    gen = torch.Generator().manual_seed(0)
    print(f"{torch.cuda.get_device_name(0)}; {cg.dom.ncells} cells")
    for name, P in states.items():
        Pc = P.cpu()
        Pj = torch.nextafter(Pc, Pc + torch.randint(
            -1, 2, Pc.shape, generator=gen).float() * 1e30)
        for frozen in (True, False):
            kw = dict(cfl=cs.PI_CFL, freeze_limiter=frozen)
            gg, Qg = newton_map(cg.bt, cg.fluid, P, cg.apply_bcs,
                                active=act_g, **kw)
            gc, Qc = newton_map(cc.bt, cc.fluid, Pc, cc.apply_bcs,
                                active=act_c, **kw)
            gj, Qj = newton_map(cc.bt, cc.fluid, Pj, cc.apply_bcs,
                                active=act_c, **kw)
            rng = np.random.default_rng(9)
            scale = Qc.abs().amax(dim=0).numpy()
            v = torch.as_tensor((rng.normal(size=tuple(Qc.shape)) * 1e-3
                                 * scale).astype(np.float32))
            Ag, Ac, Aj = (Linearization(g, Q, g(Q))
                          for g, Q in ((gg, Qg), (gc, Qc), (gj, Qj)))
            Jc = Ac(v)
            print(f"{name}, freeze_limiter={frozen}: card vs CPU g "
                  f"{cs.chan_err(Ac.fx, Ag.fx.cpu()):.3e}, JVP "
                  f"{cs.chan_err(Jc, Ag(v.to(dev)).cpu()):.3e}; CPU vs CPU "
                  f"one ulp apart g {cs.chan_err(Ac.fx, Aj.fx):.3e}, JVP "
                  f"{cs.chan_err(Jc, Aj(v)):.3e}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
