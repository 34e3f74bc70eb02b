"""Integrators of the port: the path loop, the direct and collocated
integrators, and the render wrapper."""
