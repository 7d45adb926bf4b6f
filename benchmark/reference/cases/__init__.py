"""One module a case kind, found by the configuration's ``case``: its
``geometry(cfg)`` gives (mesh, body surface, outer-box families) and its
``freestream(cfg)`` the freestream primitives [p, T, u...]."""
