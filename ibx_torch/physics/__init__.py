"""Gas model, inviscid and viscous fluxes, the flow BC with its wall
model, turbulence closures and wall functions (`turbulence`) and the
integral boundary-layer closures (`ibl`), in PyTorch (float32)."""
from .bc import FlowBC, apply_flow_bc, flow_bc
from .flux import (
    inviscid_fluxes,
    inviscid_fluxes_dissipative,
    inviscid_fluxes_hll,
    jst_sensor_3pt,
    shock_sensor,
    viscous_fluxes,
)
from .fluid import (
    Fluid,
    TimeAverage,
    adjust_reynolds,
    dynamic_viscosity,
    heat_conductivity,
    isa_atmosphere,
    make_fluid,
    pressure_coefficient,
    primitive2state,
    reynolds_number,
    speed_of_sound,
    state2primitive,
    streamwise_direction,
)
from . import ibl, turbulence

__all__ = [
    "FlowBC", "apply_flow_bc", "flow_bc",
    "inviscid_fluxes", "inviscid_fluxes_dissipative", "inviscid_fluxes_hll",
    "jst_sensor_3pt", "shock_sensor", "viscous_fluxes",
    "Fluid", "TimeAverage", "adjust_reynolds", "dynamic_viscosity",
    "heat_conductivity", "isa_atmosphere", "make_fluid",
    "pressure_coefficient", "primitive2state", "reynolds_number",
    "speed_of_sound", "state2primitive", "streamwise_direction",
    "ibl", "turbulence",
]
