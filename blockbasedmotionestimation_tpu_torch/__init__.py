"""PyTorch / CUDA port of the block-based motion estimator.

The JAX package ``blockbasedmotionestimation_tpu`` is the reference; this
package reproduces it bit for bit with plain tensor code (every regularizer,
window centre, search order, capacity mode and cost; ``cost="zsad"`` on the
plain versions on every device, as the reference runs it in XLA only), and
runs its hot operations through hand-written CUDA kernels on an NVIDIA
Hopper card (``kernels/``, sources in ``csrc/``).

The port imports torch and numpy only: it keeps its own ``config``
(``MotionConfig``), ``ops.spiral`` and ``utils`` (with the native codecs in
``native/``), and imports nothing of the JAX package.

Public API:
  * MotionConfig / middlebury_config / tiny_config - pipeline configuration
  * models.engine.estimate_flow_batched / estimate_flow_driver / ... - entry
    points on (B, H, W) or (H, W) uint8 frames (numpy frames go to CUDA
    unless ``device=`` says otherwise)
  * models.sequence.run_sequence - consecutive pairs of a frame sequence,
    a checkpointed ``.flo`` each; models.evaluate - Middlebury EPE
  * ``python -m blockbasedmotionestimation_tpu_torch.cli`` (``bbme-torch``):
    estimate, evaluate, colorize, legend, sequence, middlebury
    (``--device cpu`` for the plain versions)
"""

from blockbasedmotionestimation_tpu_torch.config import (
    MotionConfig,
    middlebury_config,
    tiny_config,
)

__all__ = ["MotionConfig", "middlebury_config", "tiny_config"]
