"""A frozen copy of the port's plain paths: the BoostENeRF and BoostMVSNeRF
models, their networks, the plain ops and the kernels' plain versions
(``kernels``), trimmed to what the benchmark's cells run. It imports nothing
of the port, so a later change to the port cannot move the reference that
judges it."""
