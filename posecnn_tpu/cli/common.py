"""Shared CLI plumbing (ref: argparse patterns of tools/train_net.py:26-70,
tools/test_net.py, tools/demo.py)."""

from __future__ import annotations

import argparse
import json
import os
import subprocess

import numpy as np

from posecnn_tpu.core.config import Config, cfg_from_dict, cfg_from_file


def base_parser(description: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--cfg", dest="cfg_file", default=None, help="config YAML (ref --cfg)")
    p.add_argument("--device", default=None, help="jax platform override (cpu, cuda)")
    p.add_argument("--rand", action="store_true", help="do not fix the rng seed")
    p.add_argument(
        "--set",
        dest="set_cfgs",
        nargs="*",
        default=[],
        help="config overrides key=value (dots for nesting)",
    )
    return p


_LITERALS = {"true": True, "false": False, "null": None, "none": None, "~": None}


def parse_set_value(text: str):
    """A `--set key=value` value as a literal: bool, null, int, float,
    a JSON list or quoted string, else the bare string."""
    low = text.strip().lower()
    if low in _LITERALS:
        return _LITERALS[low]
    for cast in (int, float):
        try:
            return cast(text)
        except ValueError:
            pass
    try:
        return json.loads(text)
    except json.JSONDecodeError:
        return text


def load_config(args) -> Config:
    cfg = cfg_from_file(args.cfg_file) if args.cfg_file else Config()
    overrides: dict = {}
    for kv in args.set_cfgs:
        key, _, value = kv.partition("=")
        node = overrides
        parts = key.split(".")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = parse_set_value(value)
    if overrides:
        cfg = cfg_from_dict(overrides, base=cfg)
    return cfg


def compilation_cache_dir() -> str:
    """`JAX_COMPILATION_CACHE_DIR` when set, else `.jax_cache/` at the
    root of the checkout. The path is part of the cache key, so it is
    fixed: a directory that moves never hits."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    return os.path.join(root, ".jax_cache")


def gpu_card_line() -> str:
    """The first card's `name, power.limit` as nvidia-smi reports them:
    every time measured on a card is read against this line."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def setup_device(args=None):
    """Platform override and the persistent compilation cache, shared
    by every entry point."""
    import jax

    if getattr(args, "device", None):
        jax.config.update("jax_platforms", args.device)
    # full-size train graphs take minutes to compile; cache them
    jax.config.update("jax_compilation_cache_dir", compilation_cache_dir())
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 5.0)


def class_data_from_dataset(ds, num_points: int):
    points = ds.subsampled_points(num_points) if hasattr(ds, "subsampled_points") else None
    return points, ds.extents if hasattr(ds, "extents") else None, np.asarray(ds.symmetry)


def head_flags_from_ckpt(cfg, ckpt_path):
    """Pose-head construction flags for eval/serve/demo, ADOPTED from
    the checkpoint's recorded metadata when present.

    norm_features / quat_activation / pose_pool_size change the
    forward computation at identical parameter shapes, so a checkpoint
    trained under one setting loads silently under another and
    produces wrong poses with no error (advisor r4). Training records
    them per snapshot (core/checkpoint.save_params meta=...); here
    they override the cfg so the eval computation always matches the
    trained one. Pre-metadata checkpoints fall back to cfg with a
    warning."""
    flags = {
        "norm_features": bool(cfg.train.norm_features),
        "quat_activation": str(cfg.train.quat_activation),
        "pose_pool_size": int(cfg.train.pose_pool_size),
    }
    if not ckpt_path:
        return flags
    from posecnn_tpu.core.checkpoint import read_ckpt_meta

    meta = read_ckpt_meta(ckpt_path)
    if not meta:
        print(
            "WARNING: checkpoint records no head metadata (pre-r6 "
            f"snapshot); trusting cfg head flags {flags} — results are "
            "wrong if the checkpoint was trained under different ones"
        )
        return flags
    for k, cur in flags.items():
        if k not in meta:
            continue
        v = type(cur)(meta[k])
        if v != cur:
            print(f"checkpoint head flag {k}={v!r} overrides cfg {cur!r}")
        flags[k] = v
    return flags


def data_flags_from_ckpt(cfg, ckpt_path):
    """Synthetic-data appearance flags (orient_paint / paint_version)
    ADOPTED from the checkpoint's recorded metadata when present.

    These change the rendered appearance of the procedural class
    library, so evaluating a checkpoint under a different paint than it
    was trained with silently degrades pose accuracy (the same failure
    mode head_flags_from_ckpt guards for the model computation, on the
    data side). Returns a dict usable as
    colorize_model_library/fill_missing_points kwargs."""
    flags = {
        "orient_detail": bool(cfg.train.orient_paint),
        "paint_version": int(getattr(cfg.train, "paint_version", 3)),
    }
    if not ckpt_path:
        return flags
    from posecnn_tpu.core.checkpoint import read_ckpt_meta

    meta = read_ckpt_meta(ckpt_path)
    for src, dst in (("orient_paint", "orient_detail"), ("paint_version", "paint_version")):
        if meta and src in meta:
            v = type(flags[dst])(meta[src])
            if v != flags[dst]:
                print(f"checkpoint data flag {src}={v!r} overrides cfg {flags[dst]!r}")
            flags[dst] = v
    return flags
