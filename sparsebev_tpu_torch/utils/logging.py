"""Logging + experiment hygiene (the port's copy of
``sparsebev_tpu/utils/logging.py``): the root logger, and a snapshot of the
source tree into the work dir."""

from __future__ import annotations

import logging
import os
import shutil
import sys
from typing import Optional


def init_logging(filename: Optional[str] = None, debug: bool = False,
                 rank: int = 0) -> None:
    """Root logger with stream + optional file handlers; non-zero ranks are
    silenced (reference train.py:82-85)."""
    logging.root.handlers.clear()
    level = logging.DEBUG if debug else logging.INFO
    if rank != 0:
        level = logging.ERROR
    handlers = [logging.StreamHandler(sys.stdout)]
    if filename is not None and rank == 0:
        os.makedirs(os.path.dirname(filename) or ".", exist_ok=True)
        handlers.append(logging.FileHandler(filename))
    logging.basicConfig(
        level=level,
        format="%(asctime)s - %(levelname)s - %(message)s",
        handlers=handlers, force=True)


def backup_code(work_dir: str, repo_root: Optional[str] = None,
                verbose: bool = True) -> str:
    """Snapshot the source tree (both packages, tools, configs, tests) into
    ``work_dir/backup``."""
    repo_root = repo_root or os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    base_dir = os.path.join(work_dir, "backup")
    os.makedirs(base_dir, exist_ok=True)
    for name in ("sparsebev_tpu_torch", "sparsebev_tpu", "tools", "configs",
                 "tests"):
        src = os.path.join(repo_root, name)
        if not os.path.isdir(src):
            continue
        dst = os.path.join(base_dir, name)
        if os.path.exists(dst):
            shutil.rmtree(dst)
        shutil.copytree(src, dst, ignore=shutil.ignore_patterns(
            "__pycache__", "*.pyc", "build"))
        if verbose:
            logging.info("backup %s -> %s", src, dst)
    for f in ("chip_smoke.py", "bench.py", "__graft_entry__.py"):
        src = os.path.join(repo_root, f)
        if os.path.isfile(src):
            shutil.copy2(src, os.path.join(base_dir, f))
    return base_dir
