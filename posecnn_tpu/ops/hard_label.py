"""Hard-label op: probability + GT label → one-hot training weights.

JAX equivalent of the `Hardlabel` TF custom op
(ref: lib/hard_label_layer/hard_label_op.cc:60-117): for each pixel
with GT label g, the output one-hot weight at channel g is 1 iff
  g != -1 and (g > 0 or prob[g] < threshold)
i.e. background pixels the net already classifies confidently are
dropped from the cross-entropy target. Gradient is zero (the reference
registers a zeros gradient in hard_label_op_grad.py); we wrap in
stop_gradient for the same effect — no custom kernel needed, XLA fuses
this elementwise logic into the loss.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def hard_label(prob: jnp.ndarray, gt_label: jnp.ndarray, threshold: float) -> jnp.ndarray:
    """prob: (B, H, W, C) softmax probabilities; gt_label: (B, H, W) int32.

    Returns (B, H, W, C) float one-hot weights.
    """
    num_classes = prob.shape[-1]
    safe_gt = jnp.clip(gt_label, 0, num_classes - 1)
    prob_at_gt = jnp.take_along_axis(prob, safe_gt[..., None], axis=-1)[..., 0]
    keep = (gt_label != -1) & ((gt_label > 0) | (prob_at_gt < threshold))
    onehot = jax.nn.one_hot(safe_gt, num_classes, dtype=prob.dtype)
    out = onehot * keep[..., None].astype(prob.dtype)
    return jax.lax.stop_gradient(out)
