"""Coarse-to-fine Hough vote maximum as Pallas kernels for the GPU
(Triton route).

The single-instance Hough step (one vote maximum per class slot,
ref: hough_voting_gpu_op.cu.cc:253-333 vote accumulation +
.cu.cc:751-764 per-class argmax) only needs each slot's peak. Center
votes form cones tens of pixels wide, so the peak of a field sampled
on every `COARSE`-th cell localizes the fine peak:

  1. coarse pass: count votes on every COARSE-th Hough cell;
  2. fine pass: count votes exactly on a WINDOW×WINDOW patch of cells
     around each of the TOP_T strongest coarse cells of every slot;
  3. the slot's maximum is the argmax over its windows.

The result equals the exhaustive argmax whenever the true peak lies
within ±(WINDOW/2 − COARSE) cells of a top coarse cell
(tests/test_hough_voting.py checks the two against each other).

Both passes run one kernel. A program owns one patch of cells (the
whole coarse grid of a slot, or one fine window) and BLOCK_CELLS of
its cells, loops over the slot's samples SAMPLE_BLOCK at a time with
the cone test as masks, and keeps its sums in registers; nothing is
carried across programs. A program whose cells lie outside the
slot's vote bounding box skips the sample loop. Counts are exact
integers (in float32), so equal counts tie exactly and the argmax
takes the first cell, as the dense path does.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

BLOCK_CELLS = 128
SAMPLE_BLOCK = 32
WINDOW = 32
COARSE = 4
TOP_T = 4


def _vote_kernel(
    origin_ref,  # (P, 2) int32 patch origin [oy, ox] in cell units
    bbox_ref,  # (K, 4) per-slot vote bbox [x_lo, x_hi, y_lo, y_hi], pixels
    samples_ref,  # (K, 8, S): x, y, u, v, d, (t·‖uv‖)², thresh, ok
    count_ref,  # out (P, n_blocks·BLOCK_CELLS) inlier counts
    dsum_ref,  # out (P, n_blocks·BLOCK_CELLS) sums of inlier depths
    *,
    patches_per_slot: int,
    patch_w: int,
    patch_cells: int,
    stride: int,
    grid_h: int,
    grid_w: int,
    num_samples: int,
):
    p = pl.program_id(0)
    blk = pl.program_id(1)
    slot = p // patches_per_slot
    idx = blk * BLOCK_CELLS + jnp.arange(BLOCK_CELLS, dtype=jnp.int32)
    fy = origin_ref[p, 0] + idx // patch_w
    fx = origin_ref[p, 1] + idx % patch_w
    live = (idx < patch_cells) & (fy < grid_h) & (fx < grid_w)
    cy = (fy * stride).astype(jnp.float32)
    cx = (fx * stride).astype(jnp.float32)

    big = 3.0e38
    overlap = (
        (jnp.max(jnp.where(live, cx, -big)) >= bbox_ref[slot, 0])
        & (jnp.min(jnp.where(live, cx, big)) <= bbox_ref[slot, 1])
        & (jnp.max(jnp.where(live, cy, -big)) >= bbox_ref[slot, 2])
        & (jnp.min(jnp.where(live, cy, big)) <= bbox_ref[slot, 3])
    )

    def body(j, carry):
        count, dsum = carry
        cols = pl.ds(j * SAMPLE_BLOCK, SAMPLE_BLOCK)
        x, y, u, v, d, t2n2, thr, ok = (
            plgpu.load(samples_ref.at[slot, c, cols]) for c in range(8)
        )
        dx = cx[:, None] - x[None, :]
        dy = cy[:, None] - y[None, :]
        dot = u[None, :] * dx + v[None, :] * dy
        inl = (
            (dot > 0.0)
            & (dot * dot > t2n2[None, :] * (dx * dx + dy * dy))
            & (jnp.abs(dx) < thr[None, :])
            & (jnp.abs(dy) < thr[None, :])
            & (ok[None, :] > 0.0)
            & live[:, None]
        )
        count = count + jnp.sum(jnp.where(inl, 1.0, 0.0), axis=1)
        dsum = dsum + jnp.sum(jnp.where(inl, d[None, :], 0.0), axis=1)
        return count, dsum

    zeros = jnp.zeros((BLOCK_CELLS,), jnp.float32)
    count, dsum = jax.lax.cond(
        overlap,
        lambda: jax.lax.fori_loop(0, num_samples // SAMPLE_BLOCK, body, (zeros, zeros)),
        lambda: (zeros, zeros),
    )
    out = pl.ds(blk * BLOCK_CELLS, BLOCK_CELLS)
    plgpu.store(count_ref.at[p, out], count)
    plgpu.store(dsum_ref.at[p, out], dsum)


def _vote_patches(origins, bboxes, samples, *, patches_per_slot, patch_w,
                  patch_cells, stride, grid_h, grid_w, interpret):
    """Inlier counts and depth sums on P patches of cells; each (P, patch_cells)."""
    n_patches = origins.shape[0]
    n_blocks = pl.cdiv(patch_cells, BLOCK_CELLS)
    kernel = functools.partial(
        _vote_kernel,
        patches_per_slot=patches_per_slot,
        patch_w=patch_w,
        patch_cells=patch_cells,
        stride=stride,
        grid_h=grid_h,
        grid_w=grid_w,
        num_samples=samples.shape[2],
    )
    out = jax.ShapeDtypeStruct((n_patches, n_blocks * BLOCK_CELLS), jnp.float32)
    count, dsum = pl.pallas_call(
        kernel,
        out_shape=(out, out),
        grid=(n_patches, n_blocks),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=4, num_stages=1),
        interpret=interpret,
        name="hough_votes",
    )(origins, bboxes, samples)
    return count[:, :patch_cells], dsum[:, :patch_cells]


@functools.partial(
    jax.jit, static_argnames=("cell_stride", "grid_h", "grid_w", "interpret")
)
def hough_c2f_max(samples, bboxes, *, cell_stride, grid_h, grid_w, interpret=False):
    """Per-slot vote maximum by coarse-to-fine voting.

    samples: (K, 8, S) packed sample channels (see `_vote_kernel`);
    bboxes: (K, 4) vote bounding boxes.
    Returns (count, dsum, cy, cx), each (K,): the inlier count and
    inlier depth sum at the maximum and its fine-cell coordinates.
    """
    # pad the sample axis to whole blocks with ok = 0 (no votes)
    samples = jnp.pad(samples, ((0, 0), (0, 0), (0, -samples.shape[2] % SAMPLE_BLOCK)))
    k_slots = samples.shape[0]
    ch, cw = pl.cdiv(grid_h, COARSE), pl.cdiv(grid_w, COARSE)
    coarse, _ = _vote_patches(
        jnp.zeros((k_slots, 2), jnp.int32), bboxes, samples,
        patches_per_slot=1, patch_w=cw, patch_cells=ch * cw,
        stride=cell_stride * COARSE, grid_h=ch, grid_w=cw, interpret=interpret,
    )
    _, top = jax.lax.top_k(coarse, TOP_T)  # (K, TOP_T) coarse cells
    oy = jnp.clip((top // cw) * COARSE + COARSE // 2 - WINDOW // 2, 0, max(grid_h - WINDOW, 0))
    ox = jnp.clip((top % cw) * COARSE + COARSE // 2 - WINDOW // 2, 0, max(grid_w - WINDOW, 0))
    origins = jnp.stack([oy, ox], axis=-1).reshape(k_slots * TOP_T, 2).astype(jnp.int32)
    count, dsum = _vote_patches(
        origins, bboxes, samples,
        patches_per_slot=TOP_T, patch_w=WINDOW, patch_cells=WINDOW * WINDOW,
        stride=cell_stride, grid_h=grid_h, grid_w=grid_w, interpret=interpret,
    )
    count = count.reshape(k_slots, TOP_T * WINDOW * WINDOW)
    dsum = dsum.reshape(k_slots, TOP_T * WINDOW * WINDOW)
    best = jnp.argmax(count, axis=1)
    window = best // (WINDOW * WINDOW)
    cell = best % (WINDOW * WINDOW)
    pick = lambda a: jnp.take_along_axis(a, best[:, None], 1)[:, 0]
    win = lambda a: jnp.take_along_axis(a.reshape(k_slots, TOP_T), window[:, None], 1)[:, 0]
    return pick(count), pick(dsum), win(oy) + cell // WINDOW, win(ox) + cell % WINDOW
