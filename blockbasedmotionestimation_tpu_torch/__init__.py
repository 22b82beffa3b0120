"""PyTorch / CUDA port of the block-based motion estimator.

The JAX package ``blockbasedmotionestimation_tpu`` is the reference; this
package reproduces its default pipeline (the fused ``windowed`` schedule with
rival windows, ``MotionConfig()``) bit for bit with plain tensor code, and
runs its four hot operations through hand-written CUDA kernels on an NVIDIA
Hopper card (``kernels/``, sources in ``csrc/``).

Only the JAX package's jax-free modules are reused as they are: ``config``
(``MotionConfig``), ``ops.spiral`` and ``utils.synth`` / ``utils.flowio``.
Nothing here imports ``jax``.

Public API:
  * MotionConfig / middlebury_config / tiny_config - pipeline configuration
  * models.engine.estimate_flow_batched / estimate_flow_driver / ... - entry
    points on (B, H, W) or (H, W) uint8 frame tensors
"""

from blockbasedmotionestimation_tpu.config import (
    MotionConfig,
    middlebury_config,
    tiny_config,
)

__all__ = ["MotionConfig", "middlebury_config", "tiny_config"]
