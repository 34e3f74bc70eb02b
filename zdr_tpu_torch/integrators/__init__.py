"""Integrators of the port: the path loop, the direct and collocated
integrators, the unfused estimators and the render wrapper.

`get_integrator(name)` -> (estimator, backward), the JAX package's registry
(zdr_tpu/integrators/__init__.py): the unfused estimator of one sample per
lane and its hand-written backward.
"""


def get_integrator(name: str):
    if name == "collocated":
        from .collocated import collocated_backward, collocated_estimator

        return collocated_estimator, collocated_backward
    if name == "direct":
        from .direct import direct_backward, direct_estimator

        return direct_estimator, direct_backward
    if name == "path":
        from .path import path_backward, path_estimator

        return path_estimator, path_backward
    raise ValueError(f"unknown integrator {name!r}")
