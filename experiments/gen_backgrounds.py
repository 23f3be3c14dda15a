"""Generate a procedural background-compositing pool DISJOINT from the
5 real demo frames.

Round-3 lesson (the r3 demo regression): compositing
synthetic objects over the SAME real frames later used for the demo
teaches the net those exact pixels as background, killing demo
detections. The reference composites a large pool of real images
(ref: lib/gt_synthesize_layer/minibatch.py:128-160); this environment
has no such corpus, so we synthesize a varied clutter pool instead —
multi-octave value noise, color gradients, and randomly placed
rectangles/ellipses (table/furniture-like structure) with box blur.
The demo frames stay strictly held out.

Usage: python experiments/gen_backgrounds.py [out_dir] [n] [H] [W]
"""
import sys

import numpy as np


def _value_noise(rng, h, w, octaves=4, base=8):
    """Multi-octave bilinear value noise in [0,1]."""
    out = np.zeros((h, w), np.float32)
    amp, total = 1.0, 0.0
    for o in range(octaves):
        gh, gw = base * (2 ** o) + 1, base * (2 ** o) + 1
        grid = rng.rand(gh, gw).astype(np.float32)
        ys = np.linspace(0, gh - 1, h)
        xs = np.linspace(0, gw - 1, w)
        y0 = np.clip(ys.astype(int), 0, gh - 2)
        x0 = np.clip(xs.astype(int), 0, gw - 2)
        fy = (ys - y0)[:, None]
        fx = (xs - x0)[None, :]
        g = (
            grid[y0][:, x0] * (1 - fy) * (1 - fx)
            + grid[y0 + 1][:, x0] * fy * (1 - fx)
            + grid[y0][:, x0 + 1] * (1 - fy) * fx
            + grid[y0 + 1][:, x0 + 1] * fy * fx
        )
        out += amp * g
        total += amp
        amp *= 0.55
    return out / total


def _box_blur(im, k):
    if k <= 1:
        return im
    pad = k // 2
    p = np.pad(im, ((pad, pad), (pad, pad), (0, 0)), mode="edge")
    c = np.cumsum(np.cumsum(p, 0), 1)
    c = np.pad(c, ((1, 0), (1, 0), (0, 0)))
    h, w = im.shape[:2]
    out = (
        c[k : k + h, k : k + w]
        - c[:h, k : k + w]
        - c[k : k + h, :w]
        + c[:h, :w]
    ) / (k * k)
    return out


def make_background(seed, h=480, w=640):
    rng = np.random.RandomState(seed)
    # base: noise field mapped through a random 3-color gradient
    noise = _value_noise(rng, h, w, octaves=rng.randint(3, 6))
    c0, c1 = rng.rand(3) * 255, rng.rand(3) * 255
    im = noise[:, :, None] * c1 + (1 - noise[:, :, None]) * c0
    # directional lighting gradient
    ang = rng.rand() * 2 * np.pi
    yy, xx = np.mgrid[0:h, 0:w]
    grad = (np.cos(ang) * xx / w + np.sin(ang) * yy / h) * rng.uniform(-80, 80)
    im = im + grad[:, :, None]
    # clutter: random rectangles + ellipses (furniture/table-ish shapes)
    for _ in range(rng.randint(4, 14)):
        col = rng.rand(3) * 255
        cy, cx = rng.randint(0, h), rng.randint(0, w)
        rh, rw = rng.randint(h // 12, h // 2), rng.randint(w // 12, w // 2)
        if rng.rand() < 0.5:
            y0, y1 = max(0, cy - rh // 2), min(h, cy + rh // 2)
            x0, x1 = max(0, cx - rw // 2), min(w, cx + rw // 2)
            mask = np.zeros((h, w), bool)
            mask[y0:y1, x0:x1] = True
        else:
            mask = ((yy - cy) / max(rh, 1)) ** 2 + ((xx - cx) / max(rw, 1)) ** 2 < 0.25
        alpha = rng.uniform(0.5, 1.0)
        im[mask] = im[mask] * (1 - alpha) + col * alpha
    im = _box_blur(im, rng.choice([1, 3, 5, 9]))
    # mild sensor-ish noise
    im = im + rng.randn(h, w, 3) * rng.uniform(0, 6)
    return np.clip(im, 0, 255).astype(np.uint8)


def main():
    out = sys.argv[1] if len(sys.argv) > 1 else "output/bg_pool"
    n = int(sys.argv[2]) if len(sys.argv) > 2 else 48
    h = int(sys.argv[3]) if len(sys.argv) > 3 else 480
    w = int(sys.argv[4]) if len(sys.argv) > 4 else 640
    import os

    from PIL import Image

    os.makedirs(out, exist_ok=True)
    for i in range(n):
        Image.fromarray(make_background(1000 + i, h, w)).save(
            f"{out}/bg_{i:03d}.png"
        )
    print(f"wrote {n} procedural backgrounds to {out}")


if __name__ == "__main__":
    main()
