"""VGG16 convolutional trunk, the PoseCNN feature extractor.

Architecture parity with the reference's chained-DSL trunk
(ref: lib/networks/vgg16_convs.py:79-97): conv1_1..conv5_3 with 2×2
max pools after stages 1-4 (conv5 keeps 1/16 resolution — pool5 is
intentionally absent, matching the FCN design). Returns conv4_3 (1/8)
and conv5_3 (1/16) for the skip heads.

NHWC layout, bfloat16 compute with fp32 parameters. The dual-tower
RGBD variant (`_p` suffix weight sharing, ref: vgg16_convs.py:99-126
and network.py:91-100) is expressed by running the same scope twice —
true weight sharing by construction instead of the reference's
name-aliasing .npy loader hack.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Tuple

import jax
import jax.numpy as jnp

from posecnn_tpu.models.layers import Module, Scope, conv, max_pool_2x2

# (filters, num_convs) per stage — VGG16 (ref: vgg16_convs.py:80-97)
VGG16_STAGES: Tuple[Tuple[int, int], ...] = ((64, 2), (128, 2), (256, 3), (512, 3), (512, 3))


@dataclass(frozen=True)
class VGG16Trunk(Module):
    """Returns (conv4_3, conv5_3) feature maps at 1/8 and 1/16."""

    compute_dtype: Any = jnp.bfloat16

    def __call__(self, scope: Scope, x: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
        x = x.astype(self.compute_dtype)
        conv4_3 = None
        for stage_idx, (filters, num_convs) in enumerate(VGG16_STAGES, start=1):
            for conv_idx in range(1, num_convs + 1):
                layer = scope.child(f"conv{stage_idx}_{conv_idx}")
                x = jax.nn.relu(conv(layer, x, filters, 3, self.compute_dtype))
            if stage_idx == 4:
                conv4_3 = x
            if stage_idx < 5:
                # 2×2/2 max pool, SAME padding (ref: network.py max_pool)
                x = max_pool_2x2(x)
        return conv4_3, x


def bilinear_upsample(x: jnp.ndarray, factor: int) -> jnp.ndarray:
    """Frozen bilinear ×factor upsampling (the reference's fixed-filter
    deconvolution, ref: network.py deconv with trainable=False,
    vgg16_convs.py:122,138).

    `jax.image.resize` (linear) computes the same fixed filter without
    materializing a 2·factor-wide kernel. Output size is exactly
    ×factor (the reference's deconv with SAME padding produces the same
    size).
    """
    b, h, w, c = x.shape
    return jax.image.resize(x, (b, h * factor, w * factor, c), method="linear").astype(x.dtype)
