"""Classic FCN-8s semantic segmentation network.

Parity target: the reference's `fcn8_vgg` model
(ref: lib/networks/fcn8_vgg.py, 467 LoC — VGG16 with fc6/fc7 as
convolutions, score layers at 1/32, 1/16, 1/8 fused by successive ×2
bilinear upsampling, final ×8). Design: same structural choices as
the other models (NHWC, bf16 compute), frozen bilinear upsampling.
"""

from __future__ import annotations

from typing import Any

import flax.linen as nn
import jax
import jax.numpy as jnp

from posecnn_tpu.models.vgg16 import bilinear_upsample
from posecnn_tpu.models.vgg16_flax import VGG16Trunk


class FCN8(nn.Module):
    num_classes: int
    fc_dim: int = 4096  # fc6/fc7 width (ref fcn8_vgg.py uses 4096)
    compute_dtype: Any = jnp.bfloat16

    @nn.compact
    def __call__(self, x, *, train: bool = False, keep_prob: float = 1.0, dropout_rng=None):
        conv4_3, conv5_3 = VGG16Trunk(compute_dtype=self.compute_dtype, name="trunk")(x)
        pool4 = conv4_3  # 1/8
        pool5 = nn.max_pool(conv5_3, (2, 2), strides=(2, 2), padding="SAME")  # 1/32

        rngs = jax.random.split(dropout_rng, 2) if dropout_rng is not None else (None, None)
        # fc6/fc7 as 7×7 / 1×1 convs (ref: fcn8_vgg.py fc layers)
        y = nn.relu(nn.Conv(self.fc_dim, (7, 7), padding="SAME", dtype=self.compute_dtype,
                            param_dtype=jnp.float32, name="fc6")(pool5))
        if train and keep_prob < 1.0:
            y = nn.Dropout(rate=1.0 - keep_prob, deterministic=False)(y, rng=rngs[0])
        y = nn.relu(nn.Conv(self.fc_dim, (1, 1), dtype=self.compute_dtype,
                            param_dtype=jnp.float32, name="fc7")(y))
        if train and keep_prob < 1.0:
            y = nn.Dropout(rate=1.0 - keep_prob, deterministic=False)(y, rng=rngs[1])

        score32 = nn.Conv(self.num_classes, (1, 1), dtype=self.compute_dtype,
                          param_dtype=jnp.float32, name="score_fr")(y)
        score16 = nn.Conv(self.num_classes, (1, 1), dtype=self.compute_dtype,
                          param_dtype=jnp.float32, name="score_pool5")(conv5_3)
        score8 = nn.Conv(self.num_classes, (1, 1), dtype=self.compute_dtype,
                         param_dtype=jnp.float32, name="score_pool4")(pool4)

        up32 = bilinear_upsample(score32, 2)[:, : score16.shape[1], : score16.shape[2]]
        fuse16 = score16 + up32
        up16 = bilinear_upsample(fuse16, 2)[:, : score8.shape[1], : score8.shape[2]]
        fuse8 = score8 + up16
        logits = bilinear_upsample(fuse8, 8).astype(jnp.float32)
        log_prob = jax.nn.log_softmax(logits, axis=-1)
        return log_prob, jnp.argmax(logits, -1).astype(jnp.int32)
