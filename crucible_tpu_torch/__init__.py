"""crucible_tpu_torch — the PyTorch + CUDA port of ``crucible_tpu``.

The JAX package stays beside this one as the reference: every module here
sits at the same relative path as its counterpart and keeps its public
names. Plain tensor code is eager PyTorch; the persistent path-tracing
megakernel is a CUDA C++ kernel written for Hopper (``csrc/megakernel.cu``),
with an eager-torch version of the same function beside it for CPU tensors
and for the comparisons.

Ported so far: the forward render of sphere scenes (solid and
checker-of-solid textures, default sky, static camera with defocus)
through ``models.render.render_image``. Triangles, image textures, the
spherical sky, animation and the gradient path raise
``NotImplementedError``.

Every entry point takes an explicit ``device=``. This package never imports
``jax`` or ``crucible_tpu``.
"""

__version__ = "0.1.0"

from crucible_tpu_torch.models.scene import (  # noqa: F401
    CheckerTexture,
    Dielectric,
    Emissive,
    ImageTexture,
    Lambertian,
    Metal,
    Scene,
    SceneData,
    SolidColor,
    Sphere,
    Triangle,
)
from crucible_tpu_torch.models.camera import Camera  # noqa: F401
from crucible_tpu_torch.models import demo  # noqa: F401
