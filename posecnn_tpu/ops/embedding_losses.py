"""Pixel-embedding metric losses: triplet + lifted structured.

JAX equivalents of the `Triplet` and `Liftedstruct` custom ops
(ref: lib/triplet_loss/triplet_loss_op_gpu.cu.cc:TripletForward —
squared-distance triplet hinge max(0, D_ij − D_ik + margin) averaged
over one triplet per pixel; lib/lifted_structured_loss/
lifted_structured_loss_op.cc — Song et al. CVPR16 lifted loss).

The reference samples triplets on the host (one per pixel, random
positive/negative) and hands index triples to CUDA. Here sampling is
jit-side: deterministic category-aware sampling via jax.random, the
distances via a Gram matrix matmul, hinge + mean as fused
elementwise ops — autodiff reproduces the reference's analytic
gradients (they are the plain derivative of the same expression).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def triplet_loss(
    embeddings: jnp.ndarray,  # (N, C) pixel embeddings (flattened)
    labels: jnp.ndarray,  # (N,) int class per pixel
    rng: jax.Array,
    *,
    num_triplets: int = 1024,
    margin: float = 1.0,
):
    """Sampled triplet hinge loss (ref: TripletForward semantics)."""
    n = embeddings.shape[0]
    ra, rp, rn = jax.random.split(rng, 3)
    anchors = jax.random.randint(ra, (num_triplets,), 0, n)
    # sample candidate positives/negatives; resample mask where the
    # class constraint fails (rejection via best-of-k)
    k = 8
    cand_p = jax.random.randint(rp, (num_triplets, k), 0, n)
    cand_n = jax.random.randint(rn, (num_triplets, k), 0, n)
    la = labels[anchors]
    same_p = labels[cand_p] == la[:, None]
    diff_n = labels[cand_n] != la[:, None]
    # first matching candidate (fall back to the anchor itself / first)
    p_idx = jnp.where(
        jnp.any(same_p, 1),
        cand_p[jnp.arange(num_triplets), jnp.argmax(same_p, 1)],
        anchors,
    )
    n_idx = jnp.where(
        jnp.any(diff_n, 1),
        cand_n[jnp.arange(num_triplets), jnp.argmax(diff_n, 1)],
        cand_n[:, 0],
    )
    valid = jnp.any(same_p, 1) & jnp.any(diff_n, 1)

    a = embeddings[anchors]
    p = embeddings[p_idx]
    nn_ = embeddings[n_idx]
    d_ap = jnp.sum((a - p) ** 2, -1)
    d_an = jnp.sum((a - nn_) ** 2, -1)
    hinge = jnp.maximum(d_ap - d_an + margin, 0.0) * valid
    return jnp.sum(hinge) / jnp.maximum(jnp.sum(valid), 1.0)


def lifted_structured_loss(
    embeddings: jnp.ndarray,  # (N, C)
    labels: jnp.ndarray,  # (N,)
    *,
    margin: float = 1.0,
):
    """Lifted structured embedding loss (Song et al. CVPR16; ref:
    lib/lifted_structured_loss). Dense over all pairs via a Gram
    matrix:
      J_ij = log( Σ_{k∉i} e^{m−D_ik} + Σ_{l∉j} e^{m−D_jl} ) + D_ij
      L = 1/(2|P|) Σ_{(i,j)∈P} max(0, J_ij)²
    """
    gram = jnp.dot(embeddings, embeddings.T, preferred_element_type=jnp.float32)
    sq = jnp.diag(gram)
    d = jnp.sqrt(jnp.maximum(sq[:, None] - 2 * gram + sq[None, :], 1e-12))
    pos = (labels[:, None] == labels[None, :]) & ~jnp.eye(labels.shape[0], dtype=bool)
    neg = labels[:, None] != labels[None, :]

    neg_exp = jnp.where(neg, jnp.exp(margin - d), 0.0)
    neg_sum = jnp.sum(neg_exp, axis=1)  # Σ_k e^{m−D_ik}
    j_ij = jnp.log(jnp.maximum(neg_sum[:, None] + neg_sum[None, :], 1e-12)) + d
    hinge = jnp.maximum(jnp.where(pos, j_ij, 0.0), 0.0)
    num_pos = jnp.maximum(jnp.sum(pos), 1)
    return jnp.sum(hinge**2) / (2.0 * num_pos)
