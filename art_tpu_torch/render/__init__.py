"""Wavefront integrator and renderer."""
