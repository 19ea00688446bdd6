"""The plain reference of the benchmark: 3D Gaussian splatting in plain
PyTorch (projection, SH colour, tile binning, depth-ordered blend, the
L1 + DSSIM loss and Adam), written from the method's equations and the
configuration file. It imports nothing of the program under test and
takes nothing the program made: it is handed the scene, poses and targets
that the benchmark drew, and works out everything else again.
"""
