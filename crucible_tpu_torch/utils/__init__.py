"""Math core: angles, vectors, intervals, color pipeline, counter-based RNG.

Port of ``crucible_tpu/utils``: the helpers operate on batched torch
tensors whose last axis is the component axis.
"""

from crucible_tpu_torch.utils.angles import Degrees, Radians  # noqa: F401
from crucible_tpu_torch.utils import vec  # noqa: F401
from crucible_tpu_torch.utils import interval  # noqa: F401
from crucible_tpu_torch.utils import color  # noqa: F401
from crucible_tpu_torch.utils import rng  # noqa: F401
