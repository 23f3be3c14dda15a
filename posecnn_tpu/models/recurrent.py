"""Recurrent multi-frame video segmentation network.

JAX re-design of the reference's `vgg16` video net
(ref: lib/networks/vgg16.py:41-166): per-frame VGG16 trunk + skip
seg features, hidden state warped into the current frame via
compute_flow (depth + relative camera pose), fused by the running
weighted-average cell GRU2D (ref: lib/networks/gru2d.py:25-61:
u = σ(conv1×1([x, h])), w' = w + u, h' = relu((w·h + u·x)/w')).

The reference unrolls NUM_STEPS=5 python-loop copies of the graph
with variable reuse; here the whole sequence is ONE `lax.scan` over
frames with naturally shared weights — compiled once, shardable over
batch.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import flax.linen as nn
import jax
import jax.numpy as jnp

from posecnn_tpu.models.vgg16 import bilinear_upsample
from posecnn_tpu.models.vgg16_flax import VGG16Trunk
from posecnn_tpu.ops.flow import compute_flow


class VideoState(NamedTuple):
    state: jnp.ndarray  # (B, H, W, U)
    weights: jnp.ndarray  # (B, H, W, U)
    points: jnp.ndarray  # (B, H, W, 3)


class FusionCell(nn.Module):
    """The reference's 'GRU2D' running weighted-average fusion
    (ref: gru2d.py:25-61)."""

    num_units: int
    compute_dtype: Any = jnp.float32

    @nn.compact
    def __call__(self, inputs, state, weights):
        xs = jnp.concatenate([inputs, state], axis=-1)
        u = nn.sigmoid(
            nn.Conv(
                self.num_units,
                (1, 1),
                kernel_init=nn.initializers.zeros,
                dtype=self.compute_dtype,
                param_dtype=jnp.float32,
                name="gate",
            )(xs)
        )
        new_w = weights + u
        new_h = nn.relu((weights * state + u * inputs) / jnp.maximum(new_w, 1e-10))
        return new_h, new_w


class GRUOriginalCell(nn.Module):
    """Classic convolutional GRU: reset/update gates + tanh candidate
    (ref: gru2d_original.py:23-58 — 1×1 gate conv with bias init 1,
    candidate conv over [x, r·h], h' = u·h + (1−u)·c). The running
    weight map is passed through unchanged (ref returns `weights`)."""

    num_units: int
    compute_dtype: Any = jnp.float32

    @nn.compact
    def __call__(self, inputs, state, weights):
        xs = jnp.concatenate([inputs, state], axis=-1)
        ru = nn.sigmoid(
            nn.Conv(
                2 * self.num_units, (1, 1),
                kernel_init=nn.initializers.zeros,
                bias_init=nn.initializers.ones,
                dtype=self.compute_dtype, param_dtype=jnp.float32, name="gates",
            )(xs)
        )
        r, u = jnp.split(ru, 2, axis=-1)
        cand_in = jnp.concatenate([inputs, r * state], axis=-1)
        c = nn.tanh(
            nn.Conv(
                self.num_units, (1, 1),
                dtype=self.compute_dtype, param_dtype=jnp.float32, name="candidate",
            )(cand_in)
        )
        return u * state + (1 - u) * c, weights


class Vanilla2DCell(nn.Module):
    """Vanilla conv-RNN: h' = tanh(conv3×3([x, h]))
    (ref: vanilla2d.py:23-40); weights pass through."""

    num_units: int
    compute_dtype: Any = jnp.float32

    @nn.compact
    def __call__(self, inputs, state, weights):
        xs = jnp.concatenate([inputs, state], axis=-1)
        new_h = nn.tanh(
            nn.Conv(
                self.num_units, (3, 3),
                dtype=self.compute_dtype, param_dtype=jnp.float32, name="conv",
            )(xs)
        )
        return new_h, weights


class Add2DCell(nn.Module):
    """Parameter-free running mean: h' = (x + n·h)/(n+1)
    (ref: add2d.py:20-24, `step` = frames seen so far). The step
    counter rides the weights map (incremented per call), so the cell
    keeps the uniform (inputs, state, weights) interface."""

    num_units: int
    compute_dtype: Any = jnp.float32

    @nn.compact
    def __call__(self, inputs, state, weights):
        new_h = (inputs + weights * state) / (weights + 1.0)
        return new_h, weights + 1.0


class GRU3DCell(nn.Module):
    """Voxel-grid GRU over (B, G, G, G, C) with a validity flag
    (ref: gru3d.py:24-63: u = σ(conv3d_1×1×1([x, h])),
    h' = flag·relu(u·h + (1−u)·x) + (1−flag)·h) — used by the 3D /
    backprojection experiments."""

    num_units: int
    compute_dtype: Any = jnp.float32

    @nn.compact
    def __call__(self, inputs, flag, state):
        xs = jnp.concatenate([inputs, state], axis=-1)
        u = nn.sigmoid(
            nn.Conv(
                self.num_units, (1, 1, 1),
                kernel_init=nn.initializers.zeros,
                dtype=self.compute_dtype, param_dtype=jnp.float32, name="gate",
            )(xs)
        )
        new_state = flag * nn.relu(u * state + (1 - u) * inputs)
        return new_state + (1.0 - flag) * state


FUSION_CELLS = {
    "gru2d": FusionCell,
    "gru2d_original": GRUOriginalCell,
    "vanilla2d": Vanilla2DCell,
    "add2d": Add2DCell,
}


class RecurrentSegNet(nn.Module):
    """Frame-recurrent semantic segmentation (ref: vgg16.py:41-166)."""

    num_classes: int
    num_units: int = 64
    flow_kernel_size: int = 3
    flow_threshold: float = 0.02
    flow_max_weight: float = 50.0
    cell_type: str = "gru2d"  # gru2d | gru2d_original | vanilla2d | add2d
    compute_dtype: Any = jnp.float32

    def setup(self):
        self.trunk = VGG16Trunk(compute_dtype=self.compute_dtype)
        self.score_conv5 = nn.Conv(self.num_units, (1, 1), dtype=self.compute_dtype, param_dtype=jnp.float32)
        self.score_conv4 = nn.Conv(self.num_units, (1, 1), dtype=self.compute_dtype, param_dtype=jnp.float32)
        self.fusion = FUSION_CELLS[self.cell_type](self.num_units, compute_dtype=self.compute_dtype)
        self.score = nn.Conv(self.num_classes, (1, 1), dtype=self.compute_dtype, param_dtype=jnp.float32)

    def frame_features(self, data):
        conv4_3, conv5_3 = self.trunk(data)
        s5 = nn.relu(self.score_conv5(conv5_3))
        s5_up = bilinear_upsample(s5, 2)
        s4 = nn.relu(self.score_conv4(conv4_3))
        s5_up = s5_up[:, : s4.shape[1], : s4.shape[2], :]
        return bilinear_upsample(s4 + s5_up, 8).astype(jnp.float32)

    def step(self, carry: VideoState, data, depth, meta):
        """One video step: features + state warp + fusion."""
        feats = self.frame_features(data)
        warped_state, warped_weights, points = compute_flow(
            carry.state,
            carry.weights,
            carry.points,
            depth,
            meta,
            kernel_size=self.flow_kernel_size,
            threshold=self.flow_threshold,
            max_weight=self.flow_max_weight,
        )
        fused, new_w = self.fusion(feats, warped_state, warped_weights)
        logits = self.score(fused).astype(jnp.float32)
        log_prob = jax.nn.log_softmax(logits, axis=-1)
        label = jnp.argmax(logits, axis=-1).astype(jnp.int32)
        return VideoState(state=fused, weights=new_w, points=points), (log_prob, label)

    def __call__(self, frames, depths, metas, initial_state: VideoState | None = None):
        """frames (T, B, H, W, 3), depths (T, B, H, W), metas (T, B, 48).

        Returns (log_probs (T, B, H, W, C), labels (T, B, H, W),
        final VideoState). Scan over time — one compiled step reused
        (the reference builds NUM_STEPS graph copies instead).
        """
        t, b, h, w, _ = frames.shape
        if initial_state is None:
            initial_state = VideoState(
                state=jnp.zeros((b, h, w, self.num_units), jnp.float32),
                weights=jnp.zeros((b, h, w, self.num_units), jnp.float32),
                points=jnp.zeros((b, h, w, 3), jnp.float32),
            )

        # nn.scan shares module parameters across time steps
        def body(cell, carry, xs):
            data, depth, meta = xs
            return cell.step(carry, data, depth, meta)

        scan = nn.scan(
            body,
            variable_broadcast="params",
            split_rngs={"params": False},
            in_axes=0,
            out_axes=0,
        )
        final, (log_probs, labels) = scan(self, initial_state, (frames, depths, metas))
        return log_probs, labels, final
