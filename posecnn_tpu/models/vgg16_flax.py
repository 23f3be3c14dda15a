"""VGG16 convolutional trunk in flax, shared by the off-path models
(detection, recurrent, fcn8). The flagship PoseCNN uses the plain-JAX
trunk in `models/vgg16.py`; both build the same layers with the same
parameter names.
"""

from __future__ import annotations

from typing import Any, Tuple

import flax.linen as nn
import jax.numpy as jnp

from posecnn_tpu.models.vgg16 import VGG16_STAGES


class VGG16Trunk(nn.Module):
    """Returns (conv4_3, conv5_3) feature maps at 1/8 and 1/16."""

    compute_dtype: Any = jnp.bfloat16

    @nn.compact
    def __call__(self, x: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
        x = x.astype(self.compute_dtype)
        conv4_3 = None
        for stage_idx, (filters, num_convs) in enumerate(VGG16_STAGES, start=1):
            for conv_idx in range(1, num_convs + 1):
                x = nn.Conv(
                    filters,
                    (3, 3),
                    padding="SAME",
                    dtype=self.compute_dtype,
                    param_dtype=jnp.float32,
                    name=f"conv{stage_idx}_{conv_idx}",
                )(x)
                x = nn.relu(x)
            if stage_idx == 4:
                conv4_3 = x
            if stage_idx < 5:
                # 2×2/2 max pool, SAME padding (ref: network.py max_pool)
                x = nn.max_pool(x, (2, 2), strides=(2, 2), padding="SAME")
        return conv4_3, x
