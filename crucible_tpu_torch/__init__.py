"""crucible_tpu_torch — the PyTorch + CUDA port of ``crucible_tpu``.

The JAX package stays beside this one as the reference: every module here
sits at the same relative path as its counterpart and keeps its public
names. Plain tensor code is eager PyTorch; every TPU kernel on a ported
path is a CUDA C++ kernel written for Hopper (``csrc/``), with a plain
PyTorch version of the same function beside it for CPU tensors and for the
comparisons.

Ported so far, for sphere scenes, static or moving on the linear shutter,
big ones included, and triangle meshes (``Triangle``, OBJ assets), static
or moving on the linear shutter, with solid colors, checkers nested to any
depth and image textures, the default or a spherical sky and a static or
keyframed camera with defocus: the forward render through
``models.render.render_image`` (the megakernel schedule; the staged pixel
schedule for the spherical sky and small meshes; on a card the record
schedule for image textures and nested checkers), movies through
``models.render.render_movie``, stills and movies from the command line
(``crucible-tpu-torch``, ``python -m crucible_tpu_torch.cli``) through
``Scene.render_scene``, the gradient through
``grad.loss_and_grad`` (record/replay, and direct AD), texels included,
and the inverse-rendering demo ``python -m crucible_tpu_torch.train_demo``.
Exact-time motion and the rest raise ``NotImplementedError``.

Every entry point runs on ``device="cuda"`` unless the caller names
another device. This package never imports ``jax`` or ``crucible_tpu``.
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
