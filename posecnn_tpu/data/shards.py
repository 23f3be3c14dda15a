"""Offline synthetic-data shards: write once, stream at train time.

Parity target: the reference's pre-rendered synthetic data root
(ref: cfg.TRAIN.SYNROOT/data_syn, lib/fcn/config.py:78-82, consumed
by the data layer at gt_synthesize_layer/minibatch.py with SYNITER/
SYNNUM indexing). No live GL thread runs beside the training step:
scenes are rendered offline (SyntheticSceneGenerator / native splat)
into .npz shards and streamed by a reader that applies background
compositing + augmentation at load time — keeping the domain-
randomization semantics (ref: minibatch.py:128-160 background
replacement; blob.py chromatic/noise).
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from posecnn_tpu.data.augment import add_noise, chromatic_transform
from posecnn_tpu.data.synthetic import SyntheticSceneGenerator


def write_shards(
    gen: SyntheticSceneGenerator,
    out_dir: str,
    num_samples: int,
    samples_per_shard: int = 64,
    start_index: int = 0,
):
    """Render scenes into <out_dir>/shard_%06d.npz files."""
    os.makedirs(out_dir, exist_ok=True)
    idx = start_index
    written = []
    while idx < start_index + num_samples:
        n = min(samples_per_shard, start_index + num_samples - idx)
        fields = {"image": [], "label": [], "depth": [], "poses": [], "n_poses": []}
        for _ in range(n):
            s = gen.render()
            fields["image"].append(s.image + gen.pixel_means)  # store raw
            fields["label"].append(s.label)
            fields["depth"].append(s.depth)
            padded = np.zeros((16, 13), np.float32)
            padded[: min(len(s.poses), 16)] = s.poses[:16]
            fields["poses"].append(padded)
            fields["n_poses"].append(min(len(s.poses), 16))
        path = os.path.join(out_dir, f"shard_{idx:06d}.npz")
        np.savez_compressed(
            path,
            image=np.stack(fields["image"]).astype(np.float16),
            label=np.stack(fields["label"]).astype(np.uint8),
            depth=np.stack(fields["depth"]).astype(np.float16),
            poses=np.stack(fields["poses"]),
            n_poses=np.asarray(fields["n_poses"], np.int32),
            meta=gen.k,
        )
        written.append(path)
        idx += n
    return written


class ShardReader:
    """Streams samples from shards with background compositing +
    chromatic/noise augmentation, sharded across hosts."""

    def __init__(
        self,
        shard_dir: str,
        num_classes: int,
        pixel_means,
        seed: int = 0,
        process_index: int = 0,
        process_count: int = 1,
        chromatic: bool = True,
        noise: bool = False,
        backgrounds: Optional[np.ndarray] = None,  # (N, H, W, 3) uint8
    ):
        self.paths = sorted(
            os.path.join(shard_dir, f)
            for f in os.listdir(shard_dir)
            if f.startswith("shard_") and f.endswith(".npz")
        )[process_index::process_count]
        if not self.paths:
            raise FileNotFoundError(f"no shards under {shard_dir}")
        self.num_classes = num_classes
        self.pixel_means = np.asarray(pixel_means, np.float32)
        self.rng = np.random.RandomState(seed + process_index)
        self.chromatic = chromatic
        self.noise = noise
        self.backgrounds = backgrounds
        self._cache_path = None
        self._cache = None

    def _load(self, path):
        if self._cache_path != path:
            self._cache = dict(np.load(path))
            self._cache_path = path
        return self._cache

    def sample(self):
        data = self._load(self.paths[self.rng.randint(len(self.paths))])
        i = self.rng.randint(data["image"].shape[0])
        image = data["image"][i].astype(np.float32)
        label = data["label"][i].astype(np.int32)
        depth = data["depth"][i].astype(np.float32)
        poses = data["poses"][i][: data["n_poses"][i]]

        # background compositing (ref: minibatch.py:128-160)
        bg_mask = label == 0
        if self.backgrounds is not None and len(self.backgrounds):
            bg = self.backgrounds[self.rng.randint(len(self.backgrounds))]
            image[bg_mask] = bg[bg_mask].astype(np.float32)
        if self.chromatic:
            image = chromatic_transform(image, self.rng)
        if self.noise:
            image = add_noise(image, self.rng)
        return {
            "image": image - self.pixel_means,
            "label": label,
            "depth": depth,
            "poses": poses,
            "meta_k": data["meta"],
        }
