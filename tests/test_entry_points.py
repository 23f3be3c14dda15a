"""The main path's dependencies, the compile-cache location, `--set`
parsing and chip_smoke.py's refusal to run without a GPU."""

import json
import math
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# packages a GPU host may lack: the flagship path must not import them
BLOCKED = ("flax", "yaml", "PIL", "cv2", "imageio", "orbax")

_MAIN_PATH = r'''
import importlib.abc, json, sys

BLOCKED = set(sys.argv[1].split(","))

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"blocked import: {name}")
        return None

sys.meta_path.insert(0, Block())

import jax, jax.numpy as jnp, numpy as np
from posecnn_tpu.cli.serve import InferenceEngine
from posecnn_tpu.core.config import cfg_from_dict
from posecnn_tpu.data.procedural import synthetic_class_library
from posecnn_tpu.data.synthetic import SyntheticSceneGenerator
from posecnn_tpu.engine.train import create_train_state, make_train_step
from posecnn_tpu.models import PoseCNN

c, h, w = 4, 48, 64
cfg = cfg_from_dict({"compute_dtype": "float32", "train": {
    "num_classes": c, "num_units": 8, "fc_dim": 16, "vertex_reg_2d": True,
    "pose_reg": True, "ims_per_batch": 2}, "test": {"hough_num_samples": 32}})
lib = synthetic_class_library(c, 64)
k = np.array([[60.0, 0, w / 2], [0, 60.0, h / 2], [0, 0, 1]], np.float32)
gen = SyntheticSceneGenerator(lib.points, lib.extents, k, width=w, height=h,
                              min_objects=1, max_objects=2, seed=0)
batch = {key: jnp.asarray(v) for key, v in gen.minibatch(2).items()}
model = PoseCNN(num_classes=c, num_units=8, fc_dim=16, hough_num_samples=32,
                max_objects=2, compute_dtype=jnp.float32)
ext = jnp.asarray(lib.extents)
state = create_train_state(cfg, model, jax.random.PRNGKey(0), batch, ext)
out = model.apply(state.params, batch["data"], ext, batch["meta"], train=False)
step = make_train_step(cfg, model, jnp.asarray(lib.points), ext, jnp.zeros(c))
state, metrics = step(state, batch, jax.random.PRNGKey(1))
engine = InferenceEngine(cfg, c, lib.points, lib.extents, np.zeros(c), k, height=h, width=w)
result = engine(np.zeros((h, w, 3), np.uint8))
print(json.dumps({
    "loss": float(metrics["loss"]),
    "label_shape": list(out.label_2d.shape),
    "served": sorted(result),
    "loaded": sorted(m for m in BLOCKED if m in sys.modules),
}))
'''


def test_main_path_runs_without_optional_packages():
    """PoseCNN init/apply, one train step and the inference engine run
    in a process where flax, yaml, PIL, cv2, imageio and orbax cannot be
    imported."""
    proc = subprocess.run(
        [sys.executable, "-c", _MAIN_PATH, ",".join(BLOCKED)],
        cwd=ROOT, capture_output=True, text=True, timeout=600,
        env={**os.environ, "JAX_PLATFORMS": "cpu"},
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    assert report["loaded"] == []
    assert report["label_shape"] == [2, 48, 64]
    assert math.isfinite(report["loss"])
    assert "detections" in report["served"]


def test_chip_smoke_refuses_cpu():
    """Without a GPU the smoke test exits non-zero and prints no result."""
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, "chip_smoke.py")],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={**os.environ, "JAX_PLATFORMS": "cpu"},
    )
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_compilation_cache_dir(monkeypatch):
    from posecnn_tpu.cli.common import compilation_cache_dir

    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/cache/from/env")
    assert compilation_cache_dir() == "/cache/from/env"
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR")
    assert compilation_cache_dir() == os.path.join(ROOT, ".jax_cache")


@pytest.mark.parametrize(
    "text, value",
    [
        ("3", 3), ("-2", -2), ("0.5", 0.5), ("1e-4", 1e-4),
        ("true", True), ("False", False), ("null", None), ("~", None),
        ("[0.5, 1.0]", [0.5, 1.0]), ('"7"', "7"), ("float32", "float32"),
        ("experiments/x.yaml", "experiments/x.yaml"),
    ],
)
def test_set_values_parse_without_yaml(monkeypatch, text, value):
    from posecnn_tpu.cli.common import parse_set_value

    monkeypatch.setitem(sys.modules, "yaml", None)  # import yaml → ImportError
    got = parse_set_value(text)
    assert got == value and type(got) is type(value)


def test_load_config_without_yaml(monkeypatch, tmp_path):
    from posecnn_tpu.cli.common import base_parser, load_config

    monkeypatch.setitem(sys.modules, "yaml", None)
    args = base_parser("t").parse_args(
        ["--set", "train.fc_dim=64", "train.pose_reg=true", "train.scales_base=[0.5]",
         "compute_dtype=float32"]
    )
    cfg = load_config(args)
    assert cfg.train.fc_dim == 64 and cfg.train.pose_reg is True
    assert cfg.train.scales_base == (0.5,) and cfg.compute_dtype == "float32"
    cfg_file = tmp_path / "c.yaml"
    cfg_file.write_text("train:\n  fc_dim: 64\n")
    with pytest.raises(RuntimeError, match="pyyaml"):
        load_config(base_parser("t").parse_args(["--cfg", str(cfg_file)]))
