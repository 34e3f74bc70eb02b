"""zdr_tpu_torch — the PyTorch and CUDA port of zdr_tpu.

A second package beside the JAX one, held against it as the reference: same
scene, material, camera and seed in, same image out. It imports torch and
numpy, never jax and never zdr_tpu. The direct integrator (the default)
and the path integrator, under mesh, point and environment lights, and the
collocated one render, and differentiate in the material, on a CUDA device
through hand-written kernels (kernels/csrc/direct.cu, collocated.cu,
path_loop.cu, path_loop_grad.cu) and on the CPU through their plain
PyTorch versions.

    from zdr_tpu_torch import Camera, Scene, float3
    scene = Scene(models, integrator="direct", device="cuda")
    image = scene.render(material, res=(512, 512), spp=64, seed=0)

parallel.py splits a render over the ranks of a torch.distributed group
(render_sharded, render_batch, make_mesh).
"""

from .dtypes import Camera, float3
from .scene import Scene  # noqa: I001 (first: the integrators import the scene's modules)
from .integrators.wrapper import RenderConfig
from .parallel import make_mesh, render_sharded

__all__ = ["Scene", "Camera", "float3", "RenderConfig", "render_sharded", "make_mesh"]
