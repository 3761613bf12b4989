"""Core math: planar vectors, uniform sources, camera, cuRAND XORWOW."""
