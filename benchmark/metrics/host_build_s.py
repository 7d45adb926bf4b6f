"""Seconds of the program's host build: ``case.build_seconds`` (the mesh,
faces, ghosts, stencils and tables, and their upload), and in a solver
cell the harness's clock around the solver's construction (its coarse
levels' builds)."""


def read(ctx):
    return ctx.get("host_build_s")
