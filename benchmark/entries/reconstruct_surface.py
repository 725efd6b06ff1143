"""reconstruct_surface: one call of the library's entry point per frame,
which returns with the mesh on the host."""


def solver(pt, params):
    return lambda frame: pt.reconstruct_surface(frame, params)
