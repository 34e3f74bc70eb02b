"""zdr_tpu_torch — the PyTorch and CUDA port of zdr_tpu.

A second package beside the JAX one, held against it as the reference: same
scene, material, camera and seed in, same image out. It imports torch and
numpy, never jax and never zdr_tpu. The direct integrator (the default,
under mesh, point and environment lights), the collocated one and the path
integrator render, and differentiate in the material, on a CUDA device
through hand-written kernels (kernels/csrc/direct.cu, collocated.cu,
path_loop.cu, path_loop_grad.cu) and on the CPU through their plain
PyTorch versions.

    from zdr_tpu_torch import Camera, Scene, float3
    scene = Scene(models, integrator="direct", device="cuda")
    image = scene.render(material, res=(512, 512), spp=64, seed=0)
"""

from .dtypes import Camera, float3
from .scene import Scene

__all__ = ["Scene", "Camera", "float3"]
