"""Input-pipeline throughput of the port's host data path (counterpart of
the repository's ``tools/loader_bench.py``): can the host feed the card?

    python -m sparsebev_tpu_torch.tools.loader_bench [--frames 8] [--reps 5]

A val sample of the streaming pipeline decodes 6 new 1600x900 JPEGs (the
history frames are in the ring); a train sample decodes T*6. This times the
host pipeline of ``data/pipelines.py`` (``LoadMultiViewImageFromFiles``,
then ``RandomTransformImage``: decode, resize, crop, flip) on synthetic
nuScenes-sized JPEGs, fused through the native decoder
(``data/fastloader.py``, where ``libfastloader.so`` loads) and eager with
PIL, and prints one JSON line a path with the JAX tool's keys (JPEGs/s,
samples/s, ms a sample, the host's cores, the decoder's threads). The claim
to check: the loader's samples/s at least the model's FPS
(``tools/timing.py``). ``main(argv)`` returns the rows.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time
from typing import List, Optional, Sequence

import numpy as np


def make_jpegs(root, n, hw=(900, 1600)):
    """``n`` JPEGs of low-frequency content (a realistic entropy, not white
    noise) under ``root``; returns their paths."""
    from PIL import Image
    rng = np.random.RandomState(0)
    paths = []
    for i in range(n):
        small = rng.randint(0, 255, (hw[0] // 8, hw[1] // 8, 3), np.uint8)
        arr = np.asarray(Image.fromarray(small).resize((hw[1], hw[0])))
        p = os.path.join(root, f"im{i}.jpg")
        Image.fromarray(arr).save(p, quality=90)
        paths.append(p)
    return paths


def run_pipeline(paths, lazy, ida_conf, reps):
    """Seconds a sample of the load + transform steps over ``paths``."""
    from ..data.pipelines import (LoadMultiViewImageFromFiles,
                                  RandomTransformImage)
    load = LoadMultiViewImageFromFiles(lazy=lazy)
    tr = RandomTransformImage(ida_aug_conf=ida_conf, training=False)
    t0 = time.perf_counter()
    for _ in range(reps):
        results = {"img_filename": list(paths),
                   "lidar2img": [np.eye(4, dtype=np.float32)
                                 for _ in paths]}
        results = load(results)
        results = tr(results)
        assert results["img"][0].shape[:2] == tuple(ida_conf["final_dim"])
    return (time.perf_counter() - t0) / reps


def main(argv: Optional[Sequence[str]] = None) -> List[dict]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=8,
                    help="frames per sample (T); 1 models the streaming "
                         "case")
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)

    from ..data import fastloader
    ida_conf = dict(H=900, W=1600, final_dim=(256, 704),
                    resize_lim=(0.38, 0.55), bot_pct_lim=(0.0, 0.0),
                    rot_lim=(0.0, 0.0), rand_flip=True)
    n = args.frames * 6
    rows = []
    with tempfile.TemporaryDirectory() as root:
        paths = make_jpegs(root, n)
        for name, lazy in (("fused_native", "auto"), ("eager_pil", "never")):
            if lazy == "auto" and not fastloader.available():
                print(f"# {name}: native lib not built, skipping")
                continue
            dt = run_pipeline(paths, lazy, ida_conf, args.reps)
            rows.append({"path": name, "jpegs_per_s": round(n / dt, 1),
                         "samples_per_s": round(1.0 / dt, 2),
                         "ms_per_sample": round(dt * 1e3, 1)})
    # the fused path decodes on up to 8 worker threads (and at most the
    # host's cores); the eager PIL path on one. The facts, not a projection
    for r in rows:
        r["host_cores"] = os.cpu_count() or 1
        r["fused_worker_threads"] = 8 if r["path"] == "fused_native" else 1
        print(json.dumps(r))
    return rows


if __name__ == "__main__":
    main()
