"""Probes: kernels that answer one question about the card and lie on no
path of the package."""
