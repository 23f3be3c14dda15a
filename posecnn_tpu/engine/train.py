"""Training engine: loss assembly, optimizer, jitted sharded step.

Replacement for the reference's SolverWrapper + train_net
(ref: lib/fcn/train.py:22-369, 478-563). The TF session/FIFOQueue/
enqueue-thread machinery dissolves into: a host prefetcher feeding
`jax.device_put` with a NamedSharding, and ONE donated, jitted train
step containing forward + backward + update. Loss composition matches
train_net exactly (ref: train.py:489-517):

  loss = loss_cls
       + VERTEX_W · smooth_l1_vertex
       + POSE_W · average_distance_loss
       [+ ADAPT_WEIGHT · domain CE]
       + WEIGHT_REG · L2(weights)          (via decoupled add at update)

Optimizer: SGD momentum 0.9, exponential staircase decay ×GAMMA every
STEPSIZE (ref: train.py:529-534). Multi-device: batch arrays sharded
over the mesh 'data' axis; XLA inserts the gradient all-reduce —
no hand-written collectives (SURVEY.md §2.4 table).
"""

from __future__ import annotations

import time
from functools import partial
from typing import Any, Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp
import optax

from posecnn_tpu.core.config import Config
from posecnn_tpu.ops.add_loss import average_distance_loss
from posecnn_tpu.ops.hard_label import hard_label
from posecnn_tpu.ops.losses import (
    build_vertex_targets,
    loss_cross_entropy_single_frame,
    smooth_l1_loss_vertex,
    softmax_cross_entropy_with_logits,
)


class TrainState(NamedTuple):
    params: Any
    opt_state: Any
    step: jnp.ndarray


def lr_schedule(cfg: Config) -> optax.Schedule:
    """Staircase exponential decay (ref: train.py:531-533).

    The returned schedule is evaluated on the OPTIMIZER's local step
    count, which starts at 0 at every `opt.init` — i.e. at every
    resume. That count reset is DELIBERATE, not a bug:
    fresh adam moments with full bias-corrected warmup at each resume
    are the "restart kick" the rotation recipe depends on (r6
    forensics: r5p/r5q learned rotation only after restart events;
    single-pass runs stay at chance indefinitely; the controlled
    ff-vs-count-0 A/B showed count-0 resumes kick hardest).
    Schedule HONESTY across resumes comes
    from `train.lr_step_offset` instead: the resume path sets it to
    the restored global step, so decay boundaries stay aligned to the
    global iteration without touching the optimizer counts."""
    base = optax.exponential_decay(
        init_value=cfg.train.learning_rate,
        transition_steps=cfg.train.stepsize,
        decay_rate=cfg.train.gamma,
        staircase=True,
    )
    if cfg.train.lr_step_offset:
        off = cfg.train.lr_step_offset
        return lambda count: base(count + off)
    return base


def fastforward_opt_counts(opt_state, step: int):
    """Set every `count` field in an optax state tree to `step`.

    The lr staircase (lr_schedule) is evaluated on the OPTIMIZER's
    internal step counter, which `opt.init` resets to 0 — so a
    resumed run silently restarted at the UNDECAYED lr while metrics reported the staircase value computed
    from state.step. Fast-forwarding the counts on restore makes the
    effective schedule follow the global iteration, matching the
    reference's global_step semantics (ref: train.py:529-534). Adam's
    bias correction at a large count is ~1, i.e. the long-running
    optimizer it is standing in for."""
    if hasattr(opt_state, "_fields"):  # optax NamedTuple states
        return opt_state._replace(**{
            f: (jnp.asarray(step, jnp.int32) if f == "count"
                else fastforward_opt_counts(getattr(opt_state, f), step))
            for f in opt_state._fields
        })
    if isinstance(opt_state, tuple):
        return tuple(fastforward_opt_counts(c, step) for c in opt_state)
    if isinstance(opt_state, list):
        return [fastforward_opt_counts(c, step) for c in opt_state]
    return opt_state  # param pytrees (mu/nu dicts), arrays, EmptyState


def _weight_mask(params):
    """True for >1-D leaves (conv/fc kernels) — biases are not
    regularized, matching the reference's l2_regularizer placement on
    weights only (network.py make_var)."""
    return jax.tree_util.tree_map(lambda p: p.ndim > 1, params)


def create_optimizer(cfg: Config, params) -> optax.GradientTransformation:
    txs = []
    if cfg.train.weight_reg > 0:
        txs.append(
            optax.masked(
                optax.add_decayed_weights(cfg.train.weight_reg), _weight_mask(params)
            )
        )
    if cfg.train.grad_clip > 0:
        txs.append(optax.clip_by_global_norm(cfg.train.grad_clip))
    opt = cfg.train.optimizer.lower()
    if opt == "momentum":
        txs.append(optax.sgd(lr_schedule(cfg), momentum=cfg.train.momentum))
    elif opt == "adam":
        txs.append(optax.adam(lr_schedule(cfg)))
    else:
        raise ValueError(f"unknown optimizer '{cfg.train.optimizer}'")
    return optax.chain(*txs)


def decompress_feed(batch: dict, cfg: Config) -> dict:
    """Undo data/pipeline.compact_feed on device: uint8 image back to
    mean-subtracted float32, uint8 label to int32. Dtype-triggered, so
    float feeds (tests, real-frame loader) pass through untouched; the
    cast+subtract fuses into the first conv under jit (same trick as
    the serve path, cli/serve.py:92-99)."""
    if batch.get("data") is None or batch["data"].dtype != jnp.uint8:
        return batch
    b = dict(batch)
    pm = jnp.asarray(cfg.pixel_means, jnp.float32)
    b["data"] = b["data"].astype(jnp.float32) - pm
    if "label" in b:
        b["label"] = b["label"].astype(jnp.int32)
    return b


def compute_losses(
    model,
    params,
    batch: dict,
    cfg: Config,
    points: jnp.ndarray,
    extents: jnp.ndarray,
    symmetry: jnp.ndarray,
    dropout_rng: Optional[jax.Array] = None,
):
    """Forward pass + full loss composition (ref: train.py:489-517).

    batch keys: data (B,H,W,3), label (B,H,W) int32, vertex_targets,
    vertex_weights (B,H,W,3C), meta (B,48), gt_poses (G,13),
    gt_valid (G,) [optional: data_p for RGBD]. data/label may arrive
    uint8-compressed (compact_feed) — decompressed here on device.
    """
    batch = decompress_feed(batch, cfg)
    out = model.apply(
        params,
        batch["data"],
        extents,
        batch["meta"],
        batch.get("gt_poses"),
        batch.get("gt_valid"),
        data_p=batch.get("data_p"),
        train=True,
        keep_prob=0.5,
        dropout_rng=dropout_rng,
    )
    return _compose_losses_from_outputs(out, batch, cfg, points, extents, symmetry)


def _compose_losses_from_outputs(out, batch, cfg, points, extents, symmetry):
    """Loss composition from model outputs (split from compute_losses
    so variants that also need the raw outputs — e.g. the GAN step's
    vertex_pred discriminator input — can share it)."""
    # segmentation loss on hard-label weights (ref: train.py:489-492,
    # vgg16_convs.py:148-149)
    labels_w = hard_label(out.prob, batch["label"], cfg.train.threshold_label)
    loss_cls = loss_cross_entropy_single_frame(out.log_prob, labels_w)
    total = loss_cls
    metrics = {"loss_cls": loss_cls}

    if cfg.train.vertex_reg_2d or cfg.train.vertex_reg_3d:
        if "vertex_targets" in batch:
            v_targets, v_weights = batch["vertex_targets"], batch["vertex_weights"]
        else:
            # sparse feed: build the dense (B,H,W,3C) maps ON DEVICE
            # from per-class centers/log-depths (see
            # ops/losses.build_vertex_targets — value-identical to the
            # host path, minus ~160 MB/frame of host work + transfer)
            v_targets, v_weights = build_vertex_targets(
                batch["label"],
                batch["vertex_centers"],
                batch["vertex_logz"],
                batch["vertex_valid"],
                weight_inside=cfg.train.vertex_w_inside,
            )
        loss_vertex = cfg.train.vertex_w * smooth_l1_loss_vertex(
            out.vertex_pred, v_targets, v_weights
        )
        total = total + loss_vertex
        metrics["loss_vertex"] = loss_vertex

        if cfg.train.pose_reg:
            num_valid = jnp.sum(out.hough.valid.astype(jnp.float32))
            # normalize by the WEIGHT-CARRYING rows, not every valid
            # roi: our static buffer keeps 9-jitter copies and
            # unmatched detections as valid-but-weightless rows, so
            # dividing by all of them diluted the pose loss (and its
            # gradient) ~5-9x and made loss_pose read far below its
            # true per-supervised-row value (r4 diagnosis,
            # random-rotation chance level is
            # ~0.66 per weighted row). The reference divides by its
            # dynamic roi count (.cu.cc:181), but in ITS regime nearly
            # every emitted roi is GT-matched — the weighted-row count
            # is the faithful translation of that denominator.
            num_weighted = jnp.sum(
                (
                    (jnp.max(out.hough.poses_weight, axis=1) > 0)
                    & out.hough.valid
                ).astype(jnp.float32)
            )
            loss_pose = cfg.train.pose_w * average_distance_loss(
                out.poses_pred,
                out.hough.poses_target,
                out.hough.poses_weight,
                points,
                symmetry,
                margin=0.01,
                num_valid=num_weighted,
            )
            total = total + loss_pose
            metrics["loss_pose"] = loss_pose
            metrics["num_rois"] = num_valid
            metrics["num_pose_rois"] = num_weighted

            if cfg.train.qmag_w > 0 and out.poses_tanh is not None:
                # magnitude regularizer for the linear quaternion head
                # (models/posecnn.py quat_activation note): the ADD
                # loss constrains only the 4-vector's DIRECTION, so
                # |fc8| random-walks upward unopposed and the
                # L2-normalize's 1/|x| Jacobian attenuates direction
                # learning proportionally (observed |raw| 300-1500 by
                # iter 1k on the r5 fresh-batch probe). Pinning the
                # masked magnitude near 1 keeps the effective pose
                # learning rate scale-stable; it is loss-invariant
                # (magnitude never reaches the ADD loss).
                weighted_rows = (
                    jnp.max(out.hough.poses_weight, axis=1) > 0
                ) & out.hough.valid
                masked = out.poses_tanh * out.hough.poses_weight
                mag = jnp.sqrt(jnp.sum(masked * masked, axis=1) + 1e-12)
                loss_qmag = jnp.sum(
                    jnp.where(weighted_rows, (mag - 1.0) ** 2, 0.0)
                ) / jnp.maximum(num_weighted, 1.0)
                total = total + cfg.train.qmag_w * loss_qmag
                metrics["loss_qmag"] = loss_qmag

            if cfg.train.matching:
                # render-and-compare matching loss (vgg16_full variant,
                # ref: lib/networks/vgg16_full.py + matching_loss op):
                # soft silhouette of each matched RoI's predicted pose
                # vs the predicted label mask at 1/8 resolution
                from posecnn_tpu.ops.matching_loss import matching_loss

                stride = 8
                lab_small = batch["label"][:, ::stride, ::stride]
                k_small = batch["meta"][:, :9].reshape(-1, 3, 3) / stride
                n_cls = points.shape[0]
                p_sub = points[:, :: max(points.shape[1] // 64, 1)]

                def roi_matching(roi, pose_q4c, pose_init, w4c, valid):
                    b_i = jnp.clip(roi[0].astype(jnp.int32), 0, lab_small.shape[0] - 1)
                    cls = jnp.clip(roi[1].astype(jnp.int32), 0, n_cls - 1)
                    q = jax.lax.dynamic_slice(pose_q4c, (4 * cls,), (4,))
                    t = pose_init[4:7]
                    mask = (lab_small[b_i] == cls).astype(jnp.float32)
                    has = jnp.sum(jax.lax.dynamic_slice(w4c, (4 * cls,), (4,))) > 0
                    loss = matching_loss(q, t, mask, p_sub[cls], k_small[b_i])
                    return jnp.where(valid & has, loss, 0.0), (valid & has)

                m_losses, m_valid = jax.vmap(roi_matching)(
                    out.hough.rois, out.poses_pred, out.hough.poses_init,
                    out.hough.poses_weight, out.hough.valid,
                )
                loss_match = jnp.sum(m_losses) / jnp.maximum(
                    jnp.sum(m_valid.astype(jnp.float32)), 1.0
                )
                total = total + loss_match
                metrics["loss_match"] = loss_match

            if cfg.train.adapt and out.domain_logits is not None:
                dom_ce = softmax_cross_entropy_with_logits(
                    out.domain_logits, out.hough.domains
                )
                mask = out.hough.valid.astype(jnp.float32)
                loss_domain = cfg.train.adapt_weight * jnp.sum(dom_ce * mask) / (
                    jnp.sum(mask) + 1e-10
                )
                total = total + loss_domain
                metrics["loss_domain"] = loss_domain

    metrics["loss"] = total
    return total, metrics


def create_train_state(cfg: Config, model, rng, sample_batch, extents) -> TrainState:
    sample_batch = decompress_feed(sample_batch, cfg)
    params = model.init(
        rng,
        sample_batch["data"],
        extents,
        sample_batch["meta"],
        sample_batch.get("gt_poses"),
        sample_batch.get("gt_valid"),
        data_p=sample_batch.get("data_p"),
        train=False,
    )
    opt = create_optimizer(cfg, params)
    return TrainState(params=params, opt_state=opt.init(params), step=jnp.zeros((), jnp.int32))


def loss_point_scale(points, extents, symmetry, is_symmetric):
    """Rescale ADD-loss points + gate symmetry flags.

    The reference data layer feeds the ADD loss points scaled by
    max(10, 2/max_extent) per class — normalizing per-class loss
    magnitude (the margin then acts on scaled distances) — with
    symmetric classes upweighted 4× once the SYMSIZE curriculum
    enables symmetry, and the symmetry flags zeroed before that
    (ref: gt_synthesize_layer/minibatch.py:50-65, layer.py:101-104).

    is_symmetric: traced scalar bool. Returns (points_scaled,
    symmetry_effective)."""
    points = jnp.asarray(points)
    symmetry = jnp.asarray(symmetry)
    max_ext = jnp.max(jnp.asarray(extents), axis=1)
    w = jnp.where(max_ext > 1e-6, jnp.maximum(2.0 / max_ext, 10.0), 10.0)
    scale = w * jnp.where((symmetry > 0) & is_symmetric, 4.0, 1.0)
    sym_eff = jnp.where(is_symmetric, symmetry, jnp.zeros_like(symmetry))
    return points * scale[:, None, None], sym_eff


def make_train_step(
    cfg: Config,
    model,
    points,
    extents,
    symmetry,
    *,
    mesh=None,
    donate: bool = True,
) -> Callable:
    """Build the jitted train step.

    With a mesh: batch arrays are expected sharded over 'data',
    params/state replicated (or fc-sharded over 'model'); jit + GSPMD
    insert the gradient all-reduce.
    """
    opt = None  # bound lazily so optimizer tree matches params
    symmetry = jnp.asarray(symmetry)
    points = jnp.asarray(points)

    def step_fn(state: TrainState, batch: dict, rng) -> tuple[TrainState, dict]:
        nonlocal opt
        if opt is None:
            opt = create_optimizer(cfg, state.params)
        drop_rng = jax.random.fold_in(rng, state.step)

        # SYMSIZE curriculum (ref: layer.py:101-104): before iter
        # SYMSIZE train with plain ADD; after, enable ADD-S
        is_sym = state.step >= cfg.train.symsize
        pts_eff, sym_eff = loss_point_scale(points, extents, symmetry, is_sym)

        def loss_fn(p):
            return compute_losses(
                model, p, batch, cfg, pts_eff, extents, sym_eff, dropout_rng=drop_rng
            )

        (_, metrics), grads = jax.value_and_grad(loss_fn, has_aux=True)(state.params)
        updates, new_opt_state = opt.update(grads, state.opt_state, state.params)
        new_params = optax.apply_updates(state.params, updates)
        new_state = TrainState(
            params=new_params, opt_state=new_opt_state, step=state.step + 1
        )
        metrics["lr"] = lr_schedule(cfg)(state.step - cfg.train.lr_step_offset)
        return new_state, metrics

    donate_args = (0,) if donate else ()
    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec as P

        with mesh:
            return jax.jit(step_fn, donate_argnums=donate_args)
    return jax.jit(step_fn, donate_argnums=donate_args)


def train_loop(
    cfg: Config,
    model,
    state: TrainState,
    batch_iter,
    points,
    extents,
    symmetry,
    *,
    max_iters: Optional[int] = None,
    mesh=None,
    log_fn: Optional[Callable[[int, dict], None]] = None,
    snapshot_fn: Optional[Callable[[int, TrainState], None]] = None,
):
    """Host-side training loop (ref: train_model_vertex_pose
    train.py:206-259): iterate batches, run the donated step, print
    per-DISPLAY losses, snapshot every SNAPSHOT_ITERS."""
    max_iters = max_iters or cfg.train.max_iters
    step = make_train_step(cfg, model, points, extents, symmetry, mesh=mesh)
    rng = jax.random.PRNGKey(cfg.rng_seed)
    # resume-aware numbering: a restored state carries its step count,
    # so iteration labels, snapshot names and the staircase schedule
    # all continue where the checkpoint left off (ref: restore +
    # global_step semantics, train.py:58-91,529-534)
    start = int(jax.device_get(state.step))
    if start >= max_iters:
        print(
            f"train_loop: restored step {start} >= max_iters {max_iters}; "
            "nothing to do (raise --iters to continue training)",
            flush=True,
        )
    t_start = time.time()
    for it in range(start, max_iters):
        batch = next(batch_iter)
        state, metrics = step(state, batch, rng)
        if it == start:
            # the lowering is cached by the first call: no recompile
            compiled = step.lower(state, batch, rng).compile()
            jax.block_until_ready(state)
            print(
                f"train step: first call {time.time() - t_start:.1f} s "
                f"(compile included); {compiled.memory_analysis()}",
                flush=True,
            )
        if (it + 1) % cfg.train.display == 0:
            metrics = {k: float(v) for k, v in metrics.items()}
            metrics["s_per_iter"] = (time.time() - t_start) / (it + 1 - start)
            if log_fn is not None:
                log_fn(it + 1, metrics)
            else:
                line = ", ".join(f"{k}: {v:.4f}" for k, v in metrics.items())
                print(f"iter {it + 1}/{max_iters} " + line, flush=True)
        if snapshot_fn is not None and (it + 1) % cfg.train.snapshot_iters == 0:
            snapshot_fn(it + 1, state)
    return state


class GanTrainState(NamedTuple):
    params: Any  # generator (the PoseCNN seg/vertex net)
    d_params: Any  # discriminator
    opt_state: Any
    d_opt_state: Any
    step: jnp.ndarray


def make_gan_train_step(
    cfg: Config,
    model,
    disc,
    points,
    extents,
    symmetry,
    *,
    donate: bool = True,
) -> Callable:
    """Adversarial vertex-map training (the vgg16_gan variant).

    The reference's graph (ref: lib/networks/vgg16_gan.py:146-188)
    runs a shared-weight conv discriminator twice — once on
    [255·vertex_pred, data] (fake) and once on [255·vertex_targets,
    data] (real) — and classifies per patch; the training loop for it
    is not present in the reference tree (only the graph + factory
    entry), so the update scheme here is the standard simultaneous
    non-saturating GAN step: D minimizes d_loss, G minimizes its task
    losses + gan_weight·g_loss. Both updates fuse into ONE jitted
    program (no host round trip between G and D steps)."""
    opt = None
    d_opt = None

    def step_fn(state: GanTrainState, batch: dict, rng) -> tuple[GanTrainState, dict]:
        nonlocal opt, d_opt
        if opt is None:
            opt = create_optimizer(cfg, state.params)
            d_opt = optax.adam(cfg.train.learning_rate)
        drop_rng = jax.random.fold_in(rng, state.step)

        def d_input(vertex_map):
            return jnp.concatenate(
                [255.0 * vertex_map, batch["data"]], axis=-1
            )  # (ref: vgg16_gan.py:151-156 input_d ‖ data concat)

        def g_loss_fn(p):
            total, metrics, vertex_pred = _losses_with_vertex(
                model, p, batch, cfg, points, extents, symmetry, drop_rng
            )
            fake_logits = disc.apply(state.d_params, d_input(vertex_pred))
            g_adv = jnp.mean(jax.nn.softplus(-fake_logits))
            metrics["loss_g_adv"] = g_adv
            return total + cfg.train.gan_weight * g_adv, (metrics, vertex_pred)

        (_, (metrics, vertex_pred)), grads = jax.value_and_grad(
            g_loss_fn, has_aux=True
        )(state.params)
        updates, new_opt_state = opt.update(grads, state.opt_state, state.params)
        new_params = optax.apply_updates(state.params, updates)

        if "vertex_targets" in batch:
            real_targets = batch["vertex_targets"]
        else:
            # sparse feed: the discriminator's real input is built on
            # device like the vertex loss (build_vertex_targets)
            real_targets, _ = build_vertex_targets(
                batch["label"],
                batch["vertex_centers"],
                batch["vertex_logz"],
                batch["vertex_valid"],
                weight_inside=cfg.train.vertex_w_inside,
            )

        def d_loss_fn(dp):
            real = disc.apply(dp, d_input(real_targets))
            fake = disc.apply(dp, d_input(jax.lax.stop_gradient(vertex_pred)))
            from posecnn_tpu.models.gan import gan_losses

            d_loss, _ = gan_losses(real, fake)
            return d_loss

        d_loss, d_grads = jax.value_and_grad(d_loss_fn)(state.d_params)
        d_updates, new_d_opt_state = d_opt.update(
            d_grads, state.d_opt_state, state.d_params
        )
        new_d_params = optax.apply_updates(state.d_params, d_updates)

        metrics["loss_d"] = d_loss
        metrics["lr"] = lr_schedule(cfg)(state.step - cfg.train.lr_step_offset)
        return (
            GanTrainState(
                params=new_params,
                d_params=new_d_params,
                opt_state=new_opt_state,
                d_opt_state=new_d_opt_state,
                step=state.step + 1,
            ),
            metrics,
        )

    donate_args = (0,) if donate else ()
    return jax.jit(step_fn, donate_argnums=donate_args)


def _losses_with_vertex(model, p, batch, cfg, points, extents, symmetry, drop_rng):
    """compute_losses + the vertex_pred map (needed as the GAN
    discriminator input)."""
    out = model.apply(
        p,
        batch["data"],
        extents,
        batch["meta"],
        batch.get("gt_poses"),
        batch.get("gt_valid"),
        data_p=batch.get("data_p"),
        train=True,
        keep_prob=0.5,
        dropout_rng=drop_rng,
    )
    total, metrics = _compose_losses_from_outputs(out, batch, cfg, points, extents, symmetry)
    return total, metrics, out.vertex_pred


def create_gan_train_state(cfg: Config, model, disc, rng, sample_batch, extents) -> GanTrainState:
    g_rng, d_rng = jax.random.split(rng)
    base = create_train_state(cfg, model, g_rng, sample_batch, extents)
    if "vertex_targets" in sample_batch:
        v_targets = sample_batch["vertex_targets"]
    else:  # sparse feed: build once for the discriminator init shape
        v_targets, _ = build_vertex_targets(
            sample_batch["label"],
            sample_batch["vertex_centers"],
            sample_batch["vertex_logz"],
            sample_batch["vertex_valid"],
            weight_inside=cfg.train.vertex_w_inside,
        )
    d_in = jnp.concatenate(
        [255.0 * v_targets, sample_batch["data"]], axis=-1
    )
    d_params = disc.init(d_rng, d_in)
    d_opt_state = optax.adam(cfg.train.learning_rate).init(d_params)
    return GanTrainState(
        params=base.params,
        d_params=d_params,
        opt_state=base.opt_state,
        d_opt_state=d_opt_state,
        step=jnp.asarray(0),
    )


def compute_video_losses(
    model,
    params,
    frames: jnp.ndarray,  # (T, B, H, W, 3)
    depths: jnp.ndarray,  # (T, B, H, W)
    metas: jnp.ndarray,  # (T, B, 48)
    gt_labels: jnp.ndarray,  # (T, B, H, W) int32
    num_classes: int,
):
    """Video-sequence segmentation loss: per-step normalized CE
    averaged over NUM_STEPS (ref: loss_cross_entropy train.py:440-453)."""
    log_probs, labels_pred, final = model.apply(params, frames, depths, metas)
    onehot = jax.nn.one_hot(gt_labels, num_classes, dtype=log_probs.dtype)
    ce = -jnp.sum(onehot * log_probs, axis=-1)  # (T, B, H, W)
    per_step = jnp.sum(ce, axis=(1, 2, 3)) / (
        jnp.sum(onehot, axis=(1, 2, 3, 4)) + 1e-10
    )
    loss = jnp.mean(per_step)
    return loss, {"loss": loss, "per_step": per_step, "labels_pred": labels_pred}


def make_det_train_step(
    cfg: Config, model, points=None, symmetry=None, *, donate: bool = True
) -> Callable:
    """Jitted train step for the detection variant (train_net_det,
    ref: lib/fcn/train.py:593-653): RPN CE + RPN smooth-L1 + RCNN CE +
    RCNN smooth-L1 + ADD pose loss when points/symmetry are given
    (+ weight decay via the optimizer chain)."""
    from posecnn_tpu.models.detection import detection_losses

    opt = None

    def step_fn(state: TrainState, batch: dict, rng) -> tuple[TrainState, dict]:
        nonlocal opt
        if opt is None:
            opt = create_optimizer(cfg, state.params)
        step_rng = jax.random.fold_in(rng, state.step)

        def loss_fn(p):
            out = model.apply(
                p, batch["data"], batch["gt_boxes"], batch["gt_poses"],
                batch["gt_valid"], train=True, rng=step_rng,
            )
            metrics = detection_losses(
                out, model.num_classes, points=points, symmetry=symmetry
            )
            return metrics["loss"], metrics

        (_, metrics), grads = jax.value_and_grad(loss_fn, has_aux=True)(state.params)
        updates, new_opt_state = opt.update(grads, state.opt_state, state.params)
        new_params = optax.apply_updates(state.params, updates)
        metrics["lr"] = lr_schedule(cfg)(state.step - cfg.train.lr_step_offset)
        return TrainState(new_params, new_opt_state, state.step + 1), metrics

    return jax.jit(step_fn, donate_argnums=(0,) if donate else ())


def make_seg_train_step(cfg: Config, model, *, donate: bool = True) -> Callable:
    """Jitted train step for plain segmentation backbones (the fcn8 /
    resnet50 variants — ref: lib/fcn/train.py:94-135 train_model, whose
    graph is only loss_cross_entropy on the seg scores).

    Expects batches {"data": (B,H,W,3), "label": (B,H,W) int32};
    models return (log_prob, label_pred)."""
    opt = None
    # probe the signature ONCE instead of try/except TypeError, which
    # would swallow genuine TypeErrors raised inside the model and
    # silently retrain without dropout
    import inspect

    has_dropout = "dropout_rng" in inspect.signature(model.__call__).parameters

    def step_fn(state: TrainState, batch: dict, rng) -> tuple[TrainState, dict]:
        nonlocal opt
        if opt is None:
            opt = create_optimizer(cfg, state.params)
        drop_rng = jax.random.fold_in(rng, state.step)

        def loss_fn(p):
            if has_dropout:
                log_prob, _ = model.apply(
                    p, batch["data"], train=True, dropout_rng=drop_rng
                )
            else:  # models without dropout (resnet50_seg)
                log_prob, _ = model.apply(p, batch["data"], train=True)
            onehot = jax.nn.one_hot(
                batch["label"], log_prob.shape[-1], dtype=log_prob.dtype
            )
            # normalized CE (ref: loss_cross_entropy_single_frame
            # train.py:455-465)
            loss = -jnp.sum(onehot * log_prob) / (jnp.sum(onehot) + 1e-10)
            return loss, {"loss": loss, "loss_cls": loss}

        (_, metrics), grads = jax.value_and_grad(loss_fn, has_aux=True)(state.params)
        updates, new_opt_state = opt.update(grads, state.opt_state, state.params)
        new_params = optax.apply_updates(state.params, updates)
        metrics["lr"] = lr_schedule(cfg)(state.step - cfg.train.lr_step_offset)
        return TrainState(new_params, new_opt_state, state.step + 1), metrics

    return jax.jit(step_fn, donate_argnums=(0,) if donate else ())


def make_video_train_step(
    cfg: Config, model, num_classes: int, *, donate: bool = True
) -> Callable:
    """Jitted train step for the recurrent video net (ref:
    train_model_vertex on the vgg16 video graph, lib/fcn/train.py —
    per-step normalized CE through the lax.scan unroll).

    Expects batches {"image": (T,B,H,W,3), "depth": (T,B,H,W),
    "meta": (T,B,48), "label": (T,B,H,W) int32}."""
    opt = None

    def step_fn(state: TrainState, batch: dict, rng) -> tuple[TrainState, dict]:
        nonlocal opt
        if opt is None:
            opt = create_optimizer(cfg, state.params)

        def loss_fn(p):
            loss, aux = compute_video_losses(
                model, p, batch["image"], batch["depth"], batch["meta"],
                batch["label"], num_classes,
            )
            return loss, {"loss": loss}

        (_, metrics), grads = jax.value_and_grad(loss_fn, has_aux=True)(state.params)
        updates, new_opt_state = opt.update(grads, state.opt_state, state.params)
        new_params = optax.apply_updates(state.params, updates)
        metrics["lr"] = lr_schedule(cfg)(state.step - cfg.train.lr_step_offset)
        return TrainState(new_params, new_opt_state, state.step + 1), metrics

    return jax.jit(step_fn, donate_argnums=(0,) if donate else ())
