"""The plain reference that decides ``correct``: SPH densities, the
background grid, the level set and its marching-cubes mesh worked out again
from a frame's positions in plain PyTorch, and the comparison of the
program's outputs with them. Imports nothing of the program."""
