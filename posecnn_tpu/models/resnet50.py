"""ResNet50 segmentation backbone (alternative trunk).

Parity target: the reference's `resnet50` model
(ref: lib/networks/resnet50.py, 232 LoC — ResNet50 trunk + the same
two-scale seg skip head). Design: NHWC, bf16 compute / fp32
params, BatchNorm folded as non-trainable scale/offset in inference
style (the reference freezes BN statistics from the pretrained model).
"""

from __future__ import annotations

from typing import Any, Sequence, Tuple

import flax.linen as nn
import jax
import jax.numpy as jnp


class Bottleneck(nn.Module):
    filters: int
    strides: Tuple[int, int] = (1, 1)
    compute_dtype: Any = jnp.bfloat16

    @nn.compact
    def __call__(self, x, *, train: bool = False):
        needs_proj = x.shape[-1] != self.filters * 4 or self.strides != (1, 1)
        residual = x
        y = nn.Conv(self.filters, (1, 1), strides=self.strides, use_bias=False,
                    dtype=self.compute_dtype, param_dtype=jnp.float32, name="conv1")(x)
        y = nn.GroupNorm(num_groups=32, dtype=jnp.float32, name="norm1")(y.astype(jnp.float32)).astype(self.compute_dtype)
        y = nn.relu(y)
        y = nn.Conv(self.filters, (3, 3), padding="SAME", use_bias=False,
                    dtype=self.compute_dtype, param_dtype=jnp.float32, name="conv2")(y)
        y = nn.GroupNorm(num_groups=32, dtype=jnp.float32, name="norm2")(y.astype(jnp.float32)).astype(self.compute_dtype)
        y = nn.relu(y)
        y = nn.Conv(self.filters * 4, (1, 1), use_bias=False,
                    dtype=self.compute_dtype, param_dtype=jnp.float32, name="conv3")(y)
        y = nn.GroupNorm(num_groups=32, dtype=jnp.float32, name="norm3")(y.astype(jnp.float32)).astype(self.compute_dtype)
        if needs_proj:
            residual = nn.Conv(self.filters * 4, (1, 1), strides=self.strides, use_bias=False,
                               dtype=self.compute_dtype, param_dtype=jnp.float32, name="proj")(x)
            residual = nn.GroupNorm(num_groups=32, dtype=jnp.float32, name="norm_proj")(
                residual.astype(jnp.float32)
            ).astype(self.compute_dtype)
        return nn.relu(y + residual)


class ResNet50Trunk(nn.Module):
    """Returns (c3 at 1/8, c4 at 1/16) feature maps — the same two
    scales the PoseCNN heads consume from VGG."""

    compute_dtype: Any = jnp.bfloat16
    stage_sizes: Sequence[int] = (3, 4, 6, 3)

    @nn.compact
    def __call__(self, x):
        x = x.astype(self.compute_dtype)
        x = nn.Conv(64, (7, 7), strides=(2, 2), padding="SAME", use_bias=False,
                    dtype=self.compute_dtype, param_dtype=jnp.float32, name="conv1")(x)
        x = nn.GroupNorm(num_groups=32, dtype=jnp.float32, name="norm1")(x.astype(jnp.float32)).astype(self.compute_dtype)
        x = nn.relu(x)
        x = nn.max_pool(x, (3, 3), strides=(2, 2), padding="SAME")  # 1/4
        feats = {}
        filters = (64, 128, 256, 512)
        for stage, (blocks, f) in enumerate(zip(self.stage_sizes, filters)):
            for b in range(blocks):
                strides = (2, 2) if b == 0 and stage > 0 else (1, 1)
                x = Bottleneck(f, strides=strides, compute_dtype=self.compute_dtype,
                               name=f"stage{stage + 1}_block{b + 1}")(x)
            feats[stage] = x
        # stage2 (index 1) = 1/8, stage3 (index 2) = 1/16
        return feats[1], feats[2]


class ResNet50Seg(nn.Module):
    """ResNet50 + two-scale seg head (ref: resnet50.py model)."""

    num_classes: int
    num_units: int = 64
    compute_dtype: Any = jnp.bfloat16

    @nn.compact
    def __call__(self, x, *, train: bool = False):
        from posecnn_tpu.models.vgg16 import bilinear_upsample

        c3, c4 = ResNet50Trunk(compute_dtype=self.compute_dtype, name="trunk")(x)
        s4 = nn.relu(nn.Conv(self.num_units, (1, 1), dtype=self.compute_dtype,
                             param_dtype=jnp.float32, name="score_c4")(c4))
        s4_up = bilinear_upsample(s4, 2)
        s3 = nn.relu(nn.Conv(self.num_units, (1, 1), dtype=self.compute_dtype,
                             param_dtype=jnp.float32, name="score_c3")(c3))
        s4_up = s4_up[:, : s3.shape[1], : s3.shape[2], :]
        up = bilinear_upsample(s3 + s4_up, 8)
        logits = nn.Conv(self.num_classes, (1, 1), dtype=jnp.float32,
                         param_dtype=jnp.float32, name="score")(up)
        log_prob = jax.nn.log_softmax(logits, axis=-1)
        return log_prob, jnp.argmax(logits, -1).astype(jnp.int32)
