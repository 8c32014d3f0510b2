"""One-command NDS parity runner of the port (counterpart of the
repository's ``tools/parity.py``): a reference torch checkpoint, loaded as
the port loads reference ``.pth`` files, saved as a checkpoint with its
version tag, evaluated offline by the port's val CLI, and the NDS diffed
against a published figure.

With released weights and nuScenes on disk:

    python -m sparsebev_tpu_torch.tools.parity \\
        --config configs/r50_nuimg_704x256.py \\
        --torch-ckpt sparsebev_r50.pth \\
        --ann-file nuscenes/nuscenes_infos_val_sweep.pkl \\
        --data-root nuscenes --expected-nds 55.6

Until then ``--synthetic`` dry-runs every stage but the real weights and
data: a synthetic split (4 samples at the config's ``final_dim``, the
ground truth kept: ``data.val.test_mode=False``), the val CLI in a
subprocess (seeded weights unless ``--torch-ckpt``), the NDS table parsed
from its log, and ``parity.json`` in the work directory with the JAX tool's
keys (``nds``, ``expected``, ``checkpoint``, ``work_dir``, and ``diff`` /
``within_noise`` with ``--expected-nds``; the noise bar is +-0.3, the
reference README.md:37).

Loading protocol (reference train.py:160-174, val.py:122-129): the
checkpoint's ``state_dict`` with ``revise_keys=[('^backbone\\.',
'img_backbone.')]`` through ``utils/checkpoint_io.py::load_pretrained``;
its top-level ``version`` tag drives the v0.17.1 decode through
``utils/version.py::VERSION`` and is saved into the checkpoint's
``extra``. CUDA unless ``--device cpu``. ``main(argv)`` returns the
process's exit code and leaves the report in ``parity.json``.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import subprocess
import sys
import tempfile
from typing import Optional, Sequence

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def parse_args(argv: Optional[Sequence[str]] = None):
    p = argparse.ArgumentParser(description="torch-checkpoint NDS parity "
                                            "run (PyTorch)")
    p.add_argument("--config", required=True)
    p.add_argument("--torch-ckpt", default=None,
                   help=".pth checkpoint (reference release or "
                        "reproduction)")
    p.add_argument("--ann-file", default=None,
                   help="val infos pkl (overrides the config's)")
    p.add_argument("--data-root", default=None)
    p.add_argument("--expected-nds", type=float, default=None,
                   help="published NDS to diff against (noise bar +-0.3, "
                        "reference README.md:37)")
    p.add_argument("--limit", type=int, default=None)
    p.add_argument("--work-dir", default=None,
                   help="where to keep the checkpoint, the split and the "
                        "report")
    p.add_argument("--synthetic", action="store_true",
                   help="dry-run on a synthetic split with seeded weights")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu (the kernels' plain PyTorch "
                        "versions)")
    p.add_argument("--online", action="store_true",
                   help="evaluate with the streaming path instead of "
                        "offline")
    return p.parse_args(argv)


def port_checkpoint(cfg, torch_ckpt: str, work_dir: str) -> str:
    """A reference ``.pth`` -> a checkpoint of the port under ``work_dir``
    (``ckpt_0.pth``, the model's state and the version tag); returns its
    path."""
    import torch

    from ..models.detector import build_detector
    from ..utils.checkpoint_io import (load_pretrained,
                                       load_torch_checkpoint,
                                       save_checkpoint)

    sd = load_torch_checkpoint(torch_ckpt)  # sets VERSION from the tag
    model = build_detector(cfg, device="cpu", seed=0)
    load_pretrained(model, sd,
                    revise_keys=[(r"^backbone\.", "img_backbone.")])
    state = argparse.Namespace(
        model=model, optimizer=torch.optim.SGD(model.parameters(), lr=0.0),
        scheduler=None, step=0)
    path = save_checkpoint(work_dir, 0, state)  # stamps VERSION into extra
    logging.info("ported checkpoint saved to %s", path)
    return path


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = parse_args(argv)
    from ..config import Config
    from ..utils.logging import init_logging

    init_logging()
    cfg = Config.fromfile(args.config)

    work_dir = args.work_dir or tempfile.mkdtemp(prefix="parity_")
    os.makedirs(work_dir, exist_ok=True)

    overrides = []
    ann = args.ann_file
    if args.synthetic and ann is None:
        from ..data import make_synthetic_dataset
        ann = make_synthetic_dataset(os.path.join(work_dir, "synth"),
                                     num_samples=4, sweeps_between=2,
                                     image_hw=tuple(
                                         cfg.ida_aug_conf["final_dim"]))
        # synthetic eval needs the ground truth through the pipeline
        overrides += ["data.val.test_mode=False"]
    if ann:
        overrides += [f"data.val.ann_file={ann}"]
    if args.data_root is not None:
        overrides += [f"data.val.data_root={args.data_root}"]

    ckpt_path = None
    if args.torch_ckpt:
        ckpt_path = port_checkpoint(cfg, args.torch_ckpt, work_dir)
    elif not args.synthetic:
        logging.error("need --torch-ckpt (or --synthetic for a dry run)")
        return 2

    cmd = [sys.executable, "-m", "sparsebev_tpu_torch.tools.val",
           "--config", args.config, "--device", args.device,
           "--out", os.path.join(work_dir, "submission.json")]
    if ckpt_path:
        cmd += ["--weights", ckpt_path]
    if args.limit:
        cmd += ["--limit", str(args.limit)]
    if args.online:
        cmd += ["--online"]
    if overrides:
        cmd += ["--override"] + overrides
    logging.info("running: %s", " ".join(cmd))
    out = subprocess.run(cmd, capture_output=True, text=True, cwd=REPO)
    log_text = out.stdout + out.stderr
    sys.stderr.write(log_text[-4000:])
    if out.returncode != 0:
        logging.error("val failed (rc=%d)", out.returncode)
        return out.returncode

    nds = None
    for line in log_text.splitlines():
        if "NDS:" in line:
            nds = float(line.rsplit("NDS:", 1)[1])
    report = {"nds": nds, "expected": args.expected_nds,
              "checkpoint": args.torch_ckpt, "work_dir": work_dir}
    if nds is not None and args.expected_nds is not None:
        report["diff"] = round(nds - args.expected_nds, 4)
        report["within_noise"] = abs(report["diff"]) <= 0.3
    print(json.dumps(report))
    with open(os.path.join(work_dir, "parity.json"), "w") as f:
        json.dump(report, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
