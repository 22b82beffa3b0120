"""PyTorch / CUDA port of the block-based motion estimator.

The JAX package ``blockbasedmotionestimation_tpu`` is the reference; this
package reproduces its default pipeline (the fused ``windowed`` schedule with
rival windows and the stored cur=2 band, ``MotionConfig()``) bit for bit with
plain tensor code, and runs its hot operations through hand-written CUDA
kernels on an NVIDIA Hopper card (``kernels/``, sources in ``csrc/``).

The port imports torch and numpy only: it keeps its own ``config``
(``MotionConfig``) and ``ops.spiral``, and imports nothing of the JAX
package.

Public API:
  * MotionConfig / middlebury_config / tiny_config - pipeline configuration
  * models.engine.estimate_flow_batched / estimate_flow_driver / ... - entry
    points on (B, H, W) or (H, W) uint8 frames (numpy frames go to CUDA
    unless ``device=`` says otherwise)
"""

from blockbasedmotionestimation_tpu_torch.config import (
    MotionConfig,
    middlebury_config,
    tiny_config,
)

__all__ = ["MotionConfig", "middlebury_config", "tiny_config"]
