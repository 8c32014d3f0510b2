#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``sparsebev_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line; each phase
prints its wall time):
  1. environment: the card, its power limit, torch's CUDA version, nvcc,
     triton, and which JPEG decoders the host offers (``import PIL``,
     ``jpeglib.h`` / ``libjpeg.so*``, ``nvjpeg.h`` / ``libnvjpeg.so*``);
  2. build every CUDA kernel of the port from ``sparsebev_tpu_torch/csrc``
     (one nvcc per source, all started together): the y-fold pack and the
     pair-mode pack (each with its adjoint), the sampling forward, the
     sampling backward, the one-hot level sampler (two entries: all levels
     in one launch, and one level), the mixing core (two entries), the
     tap-fold epilogue and the EVA02 attention (forward, and a backward of
     three kernels); for the sampling forward
     and backward, the one-hot sampler, the mixing core and the attention,
     what ``ptxas -v`` reports per kernel (registers, shared memory, stack
     frame, spills), and the tensor-core opcodes in the attention kernel's
     SASS (``cuobjdump -sass``: it must hold TF32 HMMA);
  3. the first three kernels at the shapes of each streaming path that runs
     them against their plain PyTorch versions on the same inputs (bit for
     bit; the sampling op in fp32 within 1e-5 of the output scale), timed
     with CUDA events beside their bounds and, where one PyTorch call
     computes the same function, beside that call. At vov99 the sampling op
     is checked in both of its accumulation orders (with and without a
     group-split level), and again at P=8 for the EVA02 path; the EVA02
     attention at its global (6 x 4000 tokens) and windowed (126 x 256)
     shapes within ``ATTENTION_TOL`` of its plain version, timed beside its
     3xTF32 bound and ``F.scaled_dot_product_attention`` (whose kernels are
     named from a profiler trace); the packs again on fp32 tables at the
     eva02 shapes; then a ResNet-50 stage conv recorded on an fp32 frame
     pass of the r50 config with the process-wide cuDNN TF32 flag on,
     against the CPU in fp64 within ``CONV_FP32_TOL`` of its scale (the
     error TF32 would give is printed; the packs and the sampling op at the
     r101 shapes (5 y-fold levels from 128x352, a group-split L2); the
     sampling kernel's e4m3 route (``check_sampling_e4m3``): the vov99
     fp8l0 ring (y-fold e4m3 L0, fp32 output), an e4m3 pair L0 beside the
     group-split L3 (fp32 output), r50 with e4m3 on L1 only (bf16 output)
     and the vov99 fp8l0 ring of an fp32 model (e4m3 L0 beside fp32 levels, fp32 output),
     each bit for bit against its plain version and twice bit-equal, timed
     beside its bound (each level at its own item size) and beside the
     same values as bf16 (fp32) tables; the sampling kernel's
     chunk-split route (``check_sampling_split``): the vov99 fp8l0 ring of
     T=15 slots as 5 chunks a level and the r50 ring of T=8 slots as 2,
     each bit for bit against the unsplit route over the same values, its
     plain version and itself, timed beside its bound and the unsplit call;
  4. streaming inference at full width with seeded random weights, one new
     frame per sample of a synthetic 6-camera stream, for each path:
     ``configs/r50_nuimg_704x256.py`` (12 samples, T=8, 704x256) and
     ``configs/vov99_dd3d_1600x640_trainval_future.py`` (6 samples, T=15,
     1600x640, pair level 0) and
     ``configs/vit_eva02_1600x640_trainval_future.py`` (3 samples: EVA02
     ViT-L, 16 windowed and 8 global blocks, its own pyramid, P=8; 24
     attention launches a new frame), and the EVA02 config again with
     ``compute_dtype="float32"`` (3 samples, an fp32 ring of about 10.6
     GB; its ring held to ``RING_FP32_TOL``), the vov99 config with every
     level y-fold and ``table_fp8`` on level 0 ("vov99 fp8l0", 6 samples,
     an e4m3 L0 ring; its e4m3 sampling launches counted apart and held
     above 0) and ``configs/r101_nuimg_1408x512.py`` (6 samples: ResNet-101
     at 1408x512, 5 levels, a 5.9 GB ring) and the r50 config with
     ``table_split=2`` on every level ("r50 split", 10 samples: a ring of
     T=8 slots in two chunks a level; the stream's first sample repeats its
     keyframe over the window, so the detector copies it into free slots,
     and from sample 8 on it evicts; its split launches counted apart and
     held above 0; the head replays run over the samples whose frames the
     ring still holds; then the last sample's head over the split ring and
     over its rows as one unsplit ring, bit-equal, and the sampling kernel
     on that head's first call against the unsplit call, bit for bit, timed
     beside its bound) and the r50 config as an fp32 model with
     ``table_fp8`` on level 0 ("r50 fp32 fp8l0", 4 samples: an e4m3 L0
     ring beside fp32 rings; its launches of the sampling kernel's e4m3
     route beside fp32 levels counted apart and held above 0). The kernel
     launch counts are
     reset just before each path's run and read just after it; the outputs
     must be finite and match a second run of the same stream that uses the
     plain versions (on the EVA02 paths the ring and the head replayed over
     it; see ``compare_with_plain``). Each path's breakdown also times a
     first sample's T frame passes back to back. One more sample of the r50,
     vov99 and eva02 streams records the inputs of the next phase: an
     ``AdaptiveMixing`` call's operands (a forward hook), and at r50 one
     sampling call's points and the sample's T frames of FPN maps. Then the
     port's ``tools/fp8_drift.py`` at vov99 (4 samples through a bf16 ring,
     then through a y-fold fp8-L0 ring): its JSON line, printed, not held;
  5. the hybrid sampling path (``set_sampling_impl("hybrid")``,
     ``pack_mlvl_feats`` and slice-major ``msmv_sampling``) at r50 full
     width on those maps and points, with bf16 and fp32 features: bit for
     bit against the same call through the plain versions and within a
     stated tolerance of the "xla" y-fold path, timed beside it and beside
     the same call with the one-hot levels taken one at a time (as the path
     ran before the fused kernel), each with its kernel launches (the
     wrappers' counts, held: fewer on the fused route) and its device ops
     (a torch.profiler trace, taken again while it holds fewer ops than the
     counted launches; held where a trace holds them);
     the fused one-hot kernel against its plain version with a bf16 and an
     fp32 accumulator, with and without a y-fold prefix, and the per-level
     kernel at each level, all bit for bit and timed beside their bounds;
     the sampling forward once more on
     the recorded r50 points and ring (bit for bit against its plain
     version, timed beside the bound of those inputs and the share of
     windows that the points of one (query, slice) have in common); then
     the op-level entry points of the other kernels on the recorded
     inputs: ``mixing_core`` and ``mixing_core_batched`` at r50, vov99
     and eva02 (P = 32, 60, 120; bf16 and fp32, both on the tensor cores,
     fp32 in 3xTF32; each with its route's block, shared memory and
     registers, its achieved bytes/s and share of its bound, fp32 beside
     its bound both ways: 3xTF32 on the tensor cores and one product on
     the FMA units), ``tap_fold_epilogue`` on windows gathered from the
     r50 ring.
     Each phase's launch counts are reset just before its run and read
     just after;
  6. the training step of ``configs/r50_nuimg_704x256.py`` at full width
     (B=1, 900 + 640 denoising queries, T=8, bf16 compute / fp32 parameters,
     the backbone checkpointed, the decoder's layer remat on) through
     ``train/step.py``: seeded weights, a
     seeded synthetic batch, 4 optimizer steps on that batch with the
     step's generator re-seeded each time, so that only the updates move
     the loss. The launch counts of the pack, the sampling forward, the
     sampling backward and the pack adjoint are reset just before the steps
     and read just after (4 / 6 / 6 / 4 a step); every loss must be finite
     and step 4's lower than step 1's. One more step with the layer remat
     and one without give the step's own peak memory and time each way.
     One more step runs under
     torch.profiler with operand shapes recorded (device busy, device ops,
     and the table-gradient chain: the sampling backward kernel and every
     operator with a table-sized operand), the sampling backward is held
     against its plain version on one layer's recorded operands and on
     uniform points (fp32 and bf16 tables) and timed beside its bound with
     the zeroing of its gradient apart, step 1 is run again from the same
     weights with the plain versions (loss and six named gradients within
     stated tolerances), the reduction probe checks that the backward's
     bf16 reductions round every add, and the two pack adjoints are held
     bit for bit to their plain versions at the r50 training shapes and the
     vov99 level-0 frame shape;
  7. the training loop at r50 full width: a ``train/runner.py::Runner``
     over 3 seeded host batches (numpy, uploaded through pinned memory) with
     the timer, text logger, checkpoint (``max_keep_ckpts=1``) and
     sampler-seed hooks for 2 epochs, then a fresh ``Runner`` that resumes
     from the latest checkpoint and runs epoch 3: one checkpoint left after
     pruning, the step 6 after the resume and 9 at the end, the resumed
     weights bit-equal to the saved ones, every loss finite, the kernels'
     launches a step; ms/step, the upload of a batch, the checkpoint's size
     and its save and load seconds;
  8. the host data path and the two CLIs at r50 full width, from JPEGs on
     disk: the port's ``make_synthetic_dataset`` writes a train set (4
     samples) and a val set (4) in nuScenes' format at 1600x900 with 7
     sweeps between keyframes (48 JPEGs a sample for T=8); one epoch of the
     config's train loader alone (samples/s, the JPEG decoder, the host's
     CPU count, the collated batch's shapes and dtypes, which must equal
     ``make_host_batch``'s); then, in-process, ``tools/train.main`` on the
     r50 config with its val split keeping the ground truth (batch 1, one
     epoch, a checkpoint, the ``EvalHook`` at its end): finite losses, the
     checkpoint, NDS and mAP from the hook, the pack, sampling, sampling
     backward and pack adjoint launches of every step, ms/step as the
     ``IterTimerHook`` reads it beside phase 7's, the device's busy share
     over two steps under torch.profiler; and ``tools/val.main`` offline and
     ``--online`` (with ``--out``) on that checkpoint: ms a sample, the
     metrics' keys, the pack and sampling launches, what the ring reused;
  9. the training step of ``configs/vov99_dd3d_1600x640_trainval_future.py``
     at full width (B=1, 1600 + 640 denoising queries, T=15: 90 images of
     1600x640, pair-mode level 0, group-split pack on level 3, VoVNet
     ``with_cp`` and the decoder's layer remat) as in phase 6: launches a
     step of the packs, the sampling forward and backward and both pack
     adjoints, finite and falling losses, peak memory, ms/step, one
     profiled step, the sampling backward on one recorded layer (pair,
     y-fold and group-split levels), step 1 again with the plain versions;
     then the pair adjoint at the step's shape (90 images of level 0)
     against its plain version and the permute-copy call;
 10. the training step of ``configs/r101_nuimg_1408x512.py`` at full width
     (B=1, 900 + 640 denoising queries, T=8: 48 images of 1408x512,
     ``with_cp`` over the 33 bottlenecks, the decoder's layer remat) as in
     phase 6 (5 packs, 6 sampling calls, 6 sampling backwards and 5 pack
     adjoints a step; peak memory), then the pack adjoint at its 5 levels;
 11. the training step of ``configs/vit_eva02_1600x640_trainval_future.py``
     at full width (B=1, 1600 + 640 denoising queries, T=15: 90 images of
     1600x640, of which the first ``stop_prev_grad`` = 4 frames, 24
     images, carry gradients; EVA02 ViT-L with drop path 0.3, the block
     remat and 3 frozen blocks): first the attention forward with its
     log-sum-exp and the attention backward kernel at the step's two
     shapes (24 x 4000 tokens, 504 windows of 256) against their plain
     versions and autograd of the plain forward within
     ``ATTENTION_BWD_TOL``, two backward calls bit-equal, timed beside
     their bounds and the backward of ``F.scaled_dot_product_attention``
     (the backward's D pass, dK / dV and dQ kernels apart too); then the
     trunk gate (the backbone's
     parameter gradients over the 24 images with the kernels against the
     plain versions within ``TRUNK_GRAD_TOL`` in the step's bf16; the same
     with an fp32 compute dtype printed); then the step as in phase 6 over
     ``EVA_TRAIN_STEPS`` = 2 steps, with
     the attention's launches a step held (72 forward: with gradients,
     recomputed, detached; 24 backward), step 1's loss held to the plain
     versions' and its probed gradients printed beside a one-ulp probe
     (the seeded head amplifies any change past their tolerance);
 12. parallelism at r50 full width (``parallel_phase``): the train CLI with
     ``--multihost`` under ``torchrun --standalone --nproc_per_node 1``
     (NCCL, world 1) on 2 synthetic samples of 1600x900 JPEGs, one epoch
     of batch 1;
     the data-parallel step on two gloo ranks, two processes sharing the
     one card (this script with ``--rank dp``), one sample each
     (augmentations and dropout off, the second sample with fewer boxes so
     that the loss normalizers must be summed), in the config's bf16 and
     in fp32 with TF32 off: held to the halves reference without parallel
     code (``dp_halves``: the two samples as batches of 1 in one process,
     the normalizers summed by hand, the gradients added), loss within
     ``DP_REF_LOSS_RTOL`` and probed gradients within ``DP_REF_GRAD_TOL``;
     in fp32 also to one process over the batch of two, within
     ``TRAIN_LOSS_RTOL`` / ``TRAIN_GRAD_TOL`` (in bf16 that gap, printed,
     lies between the halves and the batch of 2 already: one process, no
     parallel code, batches of 1 and of 2 rounding apart); each rank's
     launches those of the one process; and the r50 stream with its head query-sharded over
     two gloo ranks (``--rank qshard``, 450 queries each): every decoder
     layer of the last sample within ``STREAM_TOL`` of the unsharded layer
     on the same gathered inputs, the end-to-end gap to an unsharded stream
     printed. gloo takes no CUDA tensor for most collectives, so the port's
     collective helpers stage them through host memory
     (``parallel/mesh.py``). The data-parallel check also prints a probe
     (``choice_probe``, ``first_divergence``): the one-process step over
     the batch of 2 against its halves, each FPN level's difference, the
     first of the head's module calls whose output differs, each decoder
     layer's view choices and the matcher's assignment;
 13. the side modules at full width: the FPS CLI (``tools/timing.py``
     in-process on the r50 400-query config, then on the r50 config with
     ``--e2e`` and ``--profile-dir``: JAX's JSON lines, held; the pack and
     sampling launches held above 0; ms/sample, device busy and ops a
     sample from the trace, peak memory); one r50 sample with the
     decoder's ``DUMP`` on (every stage's files, their shapes and finite
     values; the predictions bit-equal to the run with dumps off); the
     vov99 config's frame pass on the depthwise spec ``V-19-dw-eSE`` at
     1600x640 (the packs launched and bit-equal to plain); the loader bench
     and the parity dry run (``--synthetic --limit 2``, the val CLI in a
     subprocess), their JSON printed;
 14. a ``{"kernels": [...]}`` line, the ``nvidia-smi`` line, and last
     ``{"ok": true, "device": {...}}``.

Needs one CUDA card (it uses ``cuda:0`` alone); imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
PROFILE_SAMPLES = 4
# an fp32 path's ring (``ring_tol``): the frame pass in fp32 through 24
# attention calls, each within about 2e-6 of its plain version's scale,
# and the pyramid's fp32 convs; 1e-4 of each level's scale
RING_FP32_TOL = 1e-4
# the streaming paths: config, samples, the kernels each path must launch,
# the kernels checked at its shapes in phase 3 (``checks``, default all),
# and the shapes its kernels see (sampling: level shapes, pair/y-fold mode
# and group-split flags per level, frames T, queries Q, points P; the EVA02
# attention: (batch, tokens) of the global blocks, 6 views of 40x100, and
# of the windowed ones, 6 views x 21 padded 16x16 windows)
PATHS = (
    dict(name="r50", config="configs/r50_nuimg_704x256.py", samples=12,
         kernels=("pack", "sampling"), hybrid_source=True,
         levels=[(64, 176), (32, 88), (16, 44), (8, 22)],
         yfold=(True,) * 4, gsplit=(False,) * 4, t=8, q=900, p=4),
    dict(name="vov99", config="configs/vov99_dd3d_1600x640_trainval_future.py",
         samples=6, kernels=("pack", "pack_pair", "sampling"),
         levels=[(160, 400), (80, 200), (40, 100), (20, 50), (10, 25)],
         yfold=(False, True, True, True, True),
         gsplit=(False, False, False, True, False), t=15, q=1600, p=4),
    # the vov99 config with bench.py's fp8-L0 overrides: every level
    # y-fold, level 0's ring in e4m3 (as many bytes as the bf16 pair ring),
    # the sampling output fp32. Its kernels give their plain versions' bits
    # (the e4m3 route is checked in phase 3 by check_sampling_e4m3), so the
    # path is held end to end like vov99; no mixing capture.
    dict(name="vov99 fp8l0",
         config="configs/vov99_dd3d_1600x640_trainval_future.py",
         head_overrides=dict(table_yfold=(True,) * 5,
                             table_fp8=(True, False, False, False, False)),
         samples=6, kernels=("pack", "sampling", "sampling_e4m3"),
         checks=("pack",), capture=False,
         levels=[(160, 400), (80, 200), (40, 100), (20, 50), (10, 25)],
         yfold=(True,) * 5,
         gsplit=(False, False, False, True, False), t=15, q=1600, p=4),
    # vov99's levels and packs (checked there); P=8, so the mixing core's
    # in-points are P * T = 120: its operands are recorded for phase 5,
    # where both mixing routes run at that width (padded to 128).
    # Not ``exact``: the attention kernel is not bit-equal to its plain
    # version, so the end-to-end comparison is printed, not held (see
    # compare_with_plain), and so are step 1's probed gradients in training
    # (training_phase)
    dict(name="eva02", config="configs/vit_eva02_1600x640_trainval_future.py",
         samples=3, kernels=("pack", "pack_pair", "sampling", "attention"),
         checks=("sampling", "attention"), exact=False,
         levels=[(160, 400), (80, 200), (40, 100), (20, 50), (10, 25)],
         yfold=(False, True, True, True, True),
         gsplit=(False, False, False, True, False), t=15, q=1600, p=8,
         attention=dict(glb=(6, 4000), win=(126, 256))),
    # the same model with compute_dtype float32 (fp32 pyramid, packs, ring
    # and head): the ring is held to RING_FP32_TOL of each level's scale,
    # the head replay to the gate; the end-to-end outputs are printed, not
    # held: one fp32 ulp on 1e-5 of the ring's entries moves them 8.6 times
    # past the gate (PERF.md, section 6). Phase 3 checks the packs on
    # fp32 tables here (sampling and attention are checked in fp32 above);
    # no timing breakdown.
    dict(name="eva02 fp32",
         config="configs/vit_eva02_1600x640_trainval_future.py",
         model_overrides=dict(compute_dtype="float32"), dtype="float32",
         samples=3, kernels=("pack", "pack_pair", "sampling", "attention"),
         checks=("pack", "pack_pair"), capture=False, breakdown=False,
         exact=False, ring_tol=RING_FP32_TOL,
         levels=[(160, 400), (80, 200), (40, 100), (20, 50), (10, 25)],
         yfold=(False, True, True, True, True),
         gsplit=(False, False, False, True, False), t=15, q=1600, p=8),
    # ResNet-101 at 1408x512 (with_cp over its 33 bottlenecks in training),
    # five y-fold levels with a group-split L2; every kernel bit-exact, so
    # held end to end; no mixing capture
    dict(name="r101", config="configs/r101_nuimg_1408x512.py", samples=6,
         kernels=("pack", "sampling"), capture=False,
         levels=[(128, 352), (64, 176), (32, 88), (16, 44), (8, 22)],
         yfold=(True,) * 5, gsplit=(False, False, True, False, False), t=8,
         q=900, p=4),
    # the r50 config with chunk-split rings (table_split=2 on every level:
    # the T=8 ring slots as two chunks of 4; the config's group-split L1
    # off, as a split ring takes no group-split level, which on y-fold
    # levels changes no bit). The stream starts with its
    # keyframe repeated over the window, so the detector copies it into
    # free slots (_dedupe_slots), and after 8 frames it evicts. Held end to
    # end like r50; then check_split_stream holds the split kernel to the
    # unsplit one over the same rows. No phase-3 checks (check_sampling_
    # split runs the split route on seeded tables), no mixing capture.
    dict(name="r50 split", config="configs/r50_nuimg_704x256.py",
         head_overrides=dict(table_split=2, table_gsplit=False),
         samples=10,
         kernels=("pack", "sampling", "sampling_split"), checks=(),
         capture=False,
         levels=[(64, 176), (32, 88), (16, 44), (8, 22)],
         yfold=(True,) * 4, gsplit=(False,) * 4, t=8, q=900, p=4),
    # the r50 config as an fp32 model with level 0's ring in e4m3: the
    # other levels' rings stay fp32 (the frame's dtype, as in JAX), so the
    # sampling kernel reads an e4m3 level beside fp32 ones (its launches
    # counted apart and held above 0; the route is checked bit for bit in
    # phase 3, case (d) of check_sampling_e4m3). The fp32 packs and the
    # sampling kernel give their plain versions' bits, so the path is held
    # end to end like r50; no phase-3 checks, no mixing capture.
    dict(name="r50 fp32 fp8l0", config="configs/r50_nuimg_704x256.py",
         model_overrides=dict(compute_dtype="float32"), dtype="float32",
         head_overrides=dict(table_fp8=(True, False, False, False)),
         samples=4, kernels=("pack", "sampling", "sampling_e4m3_fp32"),
         checks=(), capture=False,
         levels=[(64, 176), (32, 88), (16, 44), (8, 22)],
         yfold=(True,) * 4, gsplit=(False, True, False, False), t=8, q=900,
         p=4),
)
# sources whose ptxas report is printed per kernel
PTXAS_REPORTS = ("msmv_sample", "msmv_sample_bwd", "msmv_onehot", "mixing")
# the plain versions issue up to ~100 small launches per call: keep the
# card busy long enough (~20 ms) that all of them are queued before it idles
PLAIN_BUSY_CYCLES = 40_000_000
# peak device-memory rate, fp32 (non-tensor-core) rate and dense bf16
# tensor-core rate by card (NVIDIA data sheets); H100 SXM is the default
_PEAKS = (("H200", 4.8e12, 67e12, 989e12),
          ("H100 NVL", 3.9e12, 60e12, 835e12),
          ("H100 PCIe", 2.0e12, 51e12, 756e12),
          ("H100", 3.35e12, 67e12, 989e12))


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


def peaks(name: str):
    for key, *rates in _PEAKS:
        if key.lower() in name.lower():
            return rates
    return _PEAKS[-1][1:]


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def _template_args(mangled: str) -> str:
    """Readable form of the template arguments these kernels use, from
    their Itanium mangling: ``f``, ``<n><name>``, ``Li<n>E``, ``Lb<0|1>E``,
    and a substitution ``S<n>_`` (here always the type named just before
    it)."""
    out, rest, named = [], mangled, None
    while rest:
        m = re.match(r"f|Li(\d+)E|Lb([01])E|(\d+)|S\d*_", rest)
        if not m:
            return mangled
        rest = rest[m.end():]
        if m.group(0).startswith("S"):
            if named is None:
                return mangled
            out.append(named)
        elif m.group(0) == "f":
            out.append("float")
        elif m.group(1):
            out.append(m.group(1))
        elif m.group(2):
            out.append("true" if m.group(2) == "1" else "false")
        else:
            n = int(m.group(3))
            named = rest[:n]
            out.append(named)
            rest = rest[n:]
    return ", ".join(out)


def _kernel_ident(mangled: str):
    """The kernel's name in a mangled entry (the identifier ending in
    ``kernel`` whose length prefix matches it: the namespace before it may
    end in digits, and the name may hold some) and what follows it; or
    ``(None, None)``."""
    for m in re.finditer(r"kernel(?=[IE])", mangled):
        end = m.end()
        for n in range(len("kernel"), end):
            digits = str(n)
            ident = mangled[end - n:end]
            if mangled[end - n - len(digits):end - n] == digits \
                    and re.fullmatch(r"[A-Za-z_]\w*", ident):
                return ident, mangled[end:]
    return None, None


def ptxas_report(text: str):
    """Per kernel of one source's ``nvcc -Xptxas -v`` output: the template
    arguments of its entry (from the mangled name), registers, bytes of
    static shared memory, stack frame and spill stores / loads."""
    rows, entry = [], None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
            # _ZN..<len>kernel_nameI<template args>EEv<parameters>
            ident, rest = _kernel_ident(name)
            k = re.match(r"I(.+?)EEv", rest) if ident else None
            entry = dict(kernel=f"{ident}<{_template_args(k.group(1))}>"
                         if k else ident or name,
                         regs=0, smem=0, stack=0, spill_stores=0,
                         spill_loads=0)
            rows.append(entry)
            continue
        if entry is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            entry["stack"], entry["spill_stores"], entry["spill_loads"] = \
                map(int, m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m:
            entry["regs"] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", line)
            entry["smem"] = int(sm.group(1)) if sm else 0
    return rows


def time_ms(torch, fn, reps: int, flush, busy_cycles=2_000_000) -> float:
    """Median device time of one call of ``fn``: the L2 is flushed and the
    card kept busy (``busy_cycles`` of spinning, ~1 ms per 2M cycles)
    before each timed call, so the host's enqueue time does not count."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(busy_cycles)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


# ------------------------------------------------------------- phase 3 --

def _int_view(torch, t):
    """The bits of ``t`` as integers of its item size."""
    return t.view({1: torch.uint8, 2: torch.int16, 4: torch.int32}[
        t.element_size()])


def _bit_equal(torch, got, want):
    return got.dtype == want.dtype and torch.equal(_int_view(torch, got),
                                                   _int_view(torch, want))


def check_pack(torch, dev, flush, bw, path):
    """The y-fold pack at every y-fold level of one frame of ``path``."""
    from sparsebev_tpu_torch.ops.msmv_pack import pack_level, pack_level_plain
    gen = torch.Generator(device=dev).manual_seed(1)
    levels = [hw for hw, yf in zip(path["levels"], path["yfold"]) if yf]
    dtype = getattr(torch, path.get("dtype", "bfloat16"))
    m, c, g = 6, 256, 4
    ms = plain_ms = 0.0
    nbytes = 0
    err = 0.0
    for h, w in levels:
        feat = torch.randn((m, h, w, c), generator=gen, device=dev,
                           dtype=dtype)
        got = pack_level(feat, g)
        want = pack_level_plain(feat, g)
        torch.cuda.synchronize()
        if not _bit_equal(torch, got, want):
            fail(f"pack kernel differs from its plain version at {h}x{w}")
        err = max(err, (got.float() - want.float()).abs().max().item())
        ms += time_ms(torch, lambda: pack_level(feat, g), 30, flush)
        plain_ms += time_ms(torch, lambda: pack_level_plain(feat, g), 20,
                            flush, PLAIN_BUSY_CYCLES)
        nbytes += (feat.numel() + got.numel()) * feat.element_size()
    bound_ms = nbytes / bw * 1e3
    log(f"pack [{path['name']}]: {str(dtype)[6:]}, bit-equal to plain at "
        f"all {len(levels)} y-fold levels; one frame {ms:.4f} ms (plain "
        f"{plain_ms:.4f} ms), bound {bound_ms:.4f} ms ({nbytes / 1e6:.1f} "
        f"MB moved)")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by="bytes", library_ms=None)


def check_pack_pair(torch, dev, flush, bw, path):
    """The pair-mode pack at ``path``'s pair levels (vov99: level 0)."""
    import torch.nn.functional as F
    from sparsebev_tpu_torch.ops.msmv_pack import (pack_level_pair,
                                                   pack_level_pair_plain)
    gen = torch.Generator(device=dev).manual_seed(3)
    levels = [hw for hw, yf in zip(path["levels"], path["yfold"]) if not yf]
    dtype = getattr(torch, path.get("dtype", "bfloat16"))
    m, c, g = 6, 256, 4
    ms = plain_ms = library_ms = 0.0
    nbytes = 0
    for h, w in levels:
        feat = torch.randn((m, h, w, c), generator=gen, device=dev,
                           dtype=dtype)
        got = pack_level_pair(feat, g)
        want = pack_level_pair_plain(feat, g)
        torch.cuda.synchronize()
        if not _bit_equal(torch, got, want):
            fail(f"pair pack kernel differs from its plain version at "
                 f"{h}x{w}")

        def library():
            return F.pad(feat.view(m, h, w, g, c // g).permute(0, 1, 3, 2, 4),
                         (0, 0, 0, 1))

        if not _bit_equal(torch, got, library()):
            fail("pair pack kernel differs from the F.pad library call")
        ms += time_ms(torch, lambda: pack_level_pair(feat, g), 30, flush)
        plain_ms += time_ms(torch, lambda: pack_level_pair_plain(feat, g),
                            20, flush)
        library_ms += time_ms(torch, library, 20, flush)
        nbytes += (feat.numel() + got.numel()) * feat.element_size()
    bound_ms = nbytes / bw * 1e3
    log(f"pack_pair [{path['name']}]: {str(dtype)[6:]}, bit-equal to plain "
        f"and to the F.pad call at {levels}; one frame {ms:.4f} ms (plain "
        f"{plain_ms:.4f} ms, F.pad {library_ms:.4f} ms), bound "
        f"{bound_ms:.4f} ms ({nbytes / 1e6:.1f} MB moved)")
    return dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by="bytes", library_ms=library_ms)


def _piece_counts(torch, packed, loc, sw):
    """Per level, how many nonzero contributions each table piece of C
    channels (a y-fold half-row or a pair row at one column) takes from
    these points: one count a piece, in the order of the table viewed as
    ``[-1, C]``."""
    from sparsebev_tpu_torch.ops.msmv_sampling import (
        _separable_slot_weights, _view_index)
    q, s, p, _ = loc.shape
    k = q * s * p
    c = packed.channels
    # a split level's chunks, in order, hold the unsplit table's rows
    numels = [sum(t.numel() for t in (lvl if isinstance(lvl, tuple)
                                      else (lvl,))) for lvl in packed.tables]
    x = loc[..., 0].reshape(k)
    y = loc[..., 1].reshape(k)
    view = _view_index(loc[..., 2].reshape(k), packed.num_views)
    slices = packed.slice_map.to(torch.int64)
    batch_row = slices.repeat_interleave(p).repeat(q)
    lw = sw.reshape(k, -1)
    counts = []
    for lvl, (h, w) in enumerate(packed.level_shapes):
        sx, ry, (wxa, wxb), (wya, wyb) = _separable_slot_weights(
            x * (w - 1), y * (h - 1), h, w)
        col = packed.row_index(batch_row, view, ry, h) * (w + 1) + sx
        if packed.yfold[lvl]:          # key: half-row of one column
            rows = [(col * 2, wya), (col * 2 + 1, wyb)]
            step = 2
        else:                          # key: pair row of one column
            col1 = packed.row_index(batch_row, view,
                                    torch.clamp(ry + 1, max=h - 1), h) \
                * (w + 1) + sx
            rows = [(col, wya), (col1, wyb)]
            step = 1
        keys = []
        for slot, wx in ((0, wxa), (1, wxb)):
            for base, wy in rows:
                live = (wx != 0) & (wy * lw[:, lvl] != 0)
                keys.append((base + slot * step)[live])
        counts.append(torch.bincount(torch.cat(keys),
                                     minlength=numels[lvl] // c))
    return counts


def _needed_bytes(torch, packed, loc, sw):
    """Bytes the sampling forward must move for THESE inputs: every table
    piece of C channels that carries a nonzero tap weight, read once, plus
    the inputs and the output. Also returns the fp32 operations of the
    fold."""
    from sparsebev_tpu_torch.ops.msmv_sampling import (level_chunk,
                                                       table_acc_dtype)
    k = loc[..., 0].numel()
    c = packed.channels
    # each level at its own item size (an e4m3 level: 1 byte), the output at
    # the accumulator's (fp32 when level 0 is e4m3)
    table_bytes = sum(int((n > 0).sum()) * c * level_chunk(t).element_size()
                      for n, t in zip(_piece_counts(torch, packed, loc, sw),
                                      packed.tables))
    io_bytes = (loc.numel() + sw.numel()) * 4 + packed.slice_map.numel() * 4 \
        + k * c * table_acc_dtype(packed).itemsize
    flops = k * len(packed.level_shapes) * c * 12
    return table_bytes + io_bytes, flops


def _window_sharing(torch, packed, loc):
    """Share of (point, level) windows that another point of the same
    (query, slice) also reads: the P points of one (query, slice) sit in
    one warp of the sampling kernel, so these are the reads that can hit in
    L1 (or merge) instead of going to L2 or device memory."""
    from sparsebev_tpu_torch.ops.msmv_sampling import (
        _separable_slot_weights, _view_index)
    q, s, p, _ = loc.shape
    k = q * s * p
    x = loc[..., 0].reshape(k)
    y = loc[..., 1].reshape(k)
    view = _view_index(loc[..., 2].reshape(k), packed.num_views)
    shared = 0
    for h, w in packed.level_shapes:
        sx, ry, _, _ = _separable_slot_weights(x * (w - 1), y * (h - 1), h, w)
        # within one (query, slice) the frame and group are the same
        key = ((view * h + ry) * (w + 1) + sx).reshape(q * s, p)
        key = key.sort(dim=1).values
        shared += int((key[:, 1:] == key[:, :-1]).sum())
    return shared / (k * len(packed.level_shapes))


def _time_sampling(torch, flush, bw, fp32_rate, packed, loc, sw, label):
    """Time the sampling forward and its plain version on these inputs
    beside their bound; logs one line that starts ``sampling [<label>``."""
    from sparsebev_tpu_torch.ops.msmv_sampling import (level_chunk,
                                                       msmv_sampling,
                                                       msmv_sampling_plain)
    ms = time_ms(torch, lambda: msmv_sampling(packed, loc, sw), 30, flush)
    plain_ms = time_ms(torch, lambda: msmv_sampling_plain(packed, loc, sw),
                       20, flush, PLAIN_BUSY_CYCLES)
    nbytes, flops = _needed_bytes(torch, packed, loc, sw)
    bound_ms = max(nbytes / bw, flops / fp32_rate) * 1e3
    bound_by = "bytes" if nbytes / bw >= flops / fp32_rate else "operations"
    windows = loc[..., 0].numel() * 4 * packed.channels * sum(
        level_chunk(t).element_size() for t in packed.tables)
    log(f"sampling [{label}: {ms:.4f} ms (plain {plain_ms:.4f} ms), bound "
        f"{bound_ms:.4f} ms by {bound_by} ({nbytes / 1e6:.1f} MB needed by "
        f"these inputs; {windows / 1e6:.1f} MB of windows if none were "
        f"shared; {100 * _window_sharing(torch, packed, loc):.1f}% of the "
        "windows are shared within a (query, slice))")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=None)


SAMPLING_SLOTS, SAMPLING_VIEWS, SAMPLING_GROUPS, SAMPLING_CG = 16, 6, 4, 64


def _sampling_inputs(torch, dev, path, gen):
    """Uniform points over ``path``'s T frames (Q, S = T * G, P) of a
    16-slot ring, softmax level weights, and the decoder's (g, t) slice
    order over ring slots of frames t = 0..T-1."""
    n, g = SAMPLING_VIEWS, SAMPLING_GROUPS
    t, q, p = path["t"], path["q"], path["p"]
    s = t * g
    loc = torch.stack([
        torch.rand((q, s, p), generator=gen, device=dev) * 1.04 - 0.02,
        torch.rand((q, s, p), generator=gen, device=dev) * 1.04 - 0.02,
        torch.randint(0, n, (q, s, p), generator=gen, device=dev) / (n - 1),
    ], -1).contiguous()
    sw = torch.softmax(torch.randn((q, s, p, len(path["levels"])),
                                   generator=gen, device=dev), -1).contiguous()
    slot_of_t = (torch.arange(20, 20 - t, -1, device=dev) % SAMPLING_SLOTS)
    slice_map = (slot_of_t[None, :] * g
                 + torch.arange(g, device=dev)[:, None]).reshape(s)
    return loc, sw, slice_map


def check_sampling(torch, dev, flush, bw, fp32_rate, path):
    """The sampling forward at ``path``'s shapes on a 16-slot ring, bf16
    and fp32, in the path's accumulation order and (with a group-split
    level) in the unsplit order too."""
    from sparsebev_tpu_torch.ops.msmv_sampling import (
        PackedFeatures, msmv_sampling, msmv_sampling_plain)
    gen = torch.Generator(device=dev).manual_seed(2)
    levels, yfold, gsplit = path["levels"], path["yfold"], path["gsplit"]
    slots, n, g, cg = (SAMPLING_SLOTS, SAMPLING_VIEWS, SAMPLING_GROUPS,
                       SAMPLING_CG)
    s = path["t"] * g
    loc, sw, slice_map = _sampling_inputs(torch, dev, path, gen)
    orders = [gsplit] + ([(False,) * len(levels)] if any(gsplit) else [])
    result = {}
    err = 0.0
    for dtype in (torch.bfloat16, torch.float32):
        tables = [torch.randn((slots * n * h * g, w + 1, (2 if yf else 1) * cg),
                              generator=gen, device=dev, dtype=dtype)
                  for (h, w), yf in zip(levels, yfold)]
        by_order = []
        for order in orders:
            packed = PackedFeatures(tables, s, n, levels, cg, num_groups=g,
                                    slice_map=slice_map, yfold=yfold,
                                    gsplit=order)
            got = msmv_sampling(packed, loc, sw)
            by_order.append(got)
            want = msmv_sampling_plain(packed, loc, sw)
            torch.cuda.synchronize()
            d = (got.float() - want.float()).abs().max().item()
            err = max(err, d)
            scale = max(1.0, want.float().abs().max().item())
            exact = _bit_equal(torch, got, want)
            name = "group-major" if any(order) else "unsplit"
            log(f"sampling [{path['name']}] {str(dtype)[6:]} {name} order: "
                f"max|kernel - plain| = {d:.3g}, bit-equal: {exact}")
            # bf16 must give the plain version's bits; fp32 may differ by
            # fp32 rounding of the same sums
            if dtype == torch.bfloat16 and not exact \
                    or not d <= 1e-5 * scale:
                fail(f"sampling kernel differs from its plain version "
                     f"({path['name']}, {dtype}, {name} order)")
        if len(by_order) == 2:
            # how far the pair levels' two accumulation orders drift apart
            d = (by_order[0].float() - by_order[1].float()).abs()
            log(f"sampling [{path['name']}] {str(dtype)[6:]}: the two orders "
                f"differ in {int((d > 0).sum())} of {d.numel()} outputs, "
                f"max {d.max().item():.4g} (output scale "
                f"{by_order[0].float().abs().max().item():.4g})")
        del by_order
        if dtype == torch.bfloat16:
            packed = PackedFeatures(tables, s, n, levels, cg, num_groups=g,
                                    slice_map=slice_map, yfold=yfold,
                                    gsplit=gsplit)
            result = _time_sampling(torch, flush, bw, fp32_rate, packed,
                                    loc, sw, f"{path['name']}] bf16")
        del tables, packed, got, want
        torch.cuda.empty_cache()
    result["max_abs_err"] = err
    return result


# the e4m3 route of the sampling kernel (phase 3): label, the path whose
# shapes it takes, the e4m3 levels and the other levels' dtype. (a) the
# vov99 fp8l0 ring: y-fold e4m3 L0, fp32 output; (b) the vov99 ring with an
# e4m3 pair L0 and the group-split L3 (the group-major order), fp32 output;
# (c) r50 with e4m3 on L1 only, bf16 output; (d) the vov99 fp8l0 ring of
# an fp32 model (``compute_dtype="float32"``): e4m3 L0 beside fp32 levels,
# fp32 output (the e4m3 level's weights still round to bf16)
E4M3_CHECKS = (
    ("vov99 fp8l0", "vov99 fp8l0", (True, False, False, False, False),
     "bfloat16"),
    ("vov99 pair e4m3 L0", "vov99", (True, False, False, False, False),
     "bfloat16"),
    ("r50 e4m3 L1", "r50", (False, True, False, False), "bfloat16"),
    ("vov99 fp8l0 fp32", "vov99 fp8l0", (True, False, False, False, False),
     "float32"),
)


def check_sampling_e4m3(torch, dev, flush, bw, fp32_rate):
    """The sampling kernel with e4m3 levels (``E4M3_CHECKS``) on a 16-slot
    ring of seeded tables: bit for bit against its plain version, and twice
    bit-equal on the same inputs; timed beside its bound (each level's bytes
    at its own item size) and beside the same call with every level in the
    other levels' dtype (the e4m3 tables upcast: the same values on the
    bf16 or the fp32 route). Returns the numbers by label, each with the
    other levels' dtype under ``base``."""
    from sparsebev_tpu_torch.ops.msmv_sampling import (
        E4M3, PackedFeatures, msmv_sampling, msmv_sampling_plain,
        table_acc_dtype)
    out = {}
    for label, pname, fp8, base in E4M3_CHECKS:
        path = next(p for p in PATHS if p["name"] == pname)
        gen = torch.Generator(device=dev).manual_seed(4)
        levels, yfold, gsplit = path["levels"], path["yfold"], path["gsplit"]
        n, g, cg = SAMPLING_VIEWS, SAMPLING_GROUPS, SAMPLING_CG
        s = path["t"] * g
        loc, sw, slice_map = _sampling_inputs(torch, dev, path, gen)
        base_dtype = getattr(torch, base)
        tables = []
        for (h, w), yf, f8 in zip(levels, yfold, fp8):
            t = torch.randn((SAMPLING_SLOTS * n * h * g, w + 1,
                             (2 if yf else 1) * cg), generator=gen,
                            device=dev, dtype=base_dtype)
            tables.append(t.to(E4M3) if f8 else t)
            del t
        packed = PackedFeatures(tables, s, n, levels, cg, num_groups=g,
                                slice_map=slice_map, yfold=yfold,
                                gsplit=gsplit)
        want_dtype = table_acc_dtype(packed)
        got = msmv_sampling(packed, loc, sw)
        again = msmv_sampling(packed, loc, sw)
        want = msmv_sampling_plain(packed, loc, sw)
        torch.cuda.synchronize()
        exact = _bit_equal(torch, got, want)
        d = (got.float() - want.float()).abs().max().item()
        tag = "b" if base == "bfloat16" else "f"
        log(f"sampling e4m3 [{label}]: levels "
            f"{''.join('8' if f else tag for f in fp8)} (8: e4m3, "
            f"{tag}: {base}), "
            f"modes {''.join('y' if yf else 'p' for yf in yfold)}, "
            f"group-split {[i for i, v in enumerate(gsplit) if v]}, output "
            f"{str(got.dtype)[6:]}: max|kernel - plain| = {d:.3g}, bit-equal "
            f"to plain: {exact}, two calls bit-equal: "
            f"{_bit_equal(torch, got, again)}")
        if got.dtype != want_dtype or not exact \
                or not _bit_equal(torch, got, again):
            fail(f"sampling kernel with e4m3 levels differs from its plain "
                 f"version or from itself ({label})")
        del got, again, want
        res = _time_sampling(torch, flush, bw, fp32_rate, packed, loc, sw,
                             f"e4m3 {label}] e4m3 route")
        as_base = packed.replace(tables=[t.to(base_dtype) for t in tables])
        key = "bf16_route_ms" if base == "bfloat16" else "fp32_route_ms"
        res[key] = time_ms(torch, lambda: msmv_sampling(as_base, loc, sw),
                           30, flush)
        log(f"sampling e4m3 [{label}]: the same call on the same values as "
            f"{base} tables (the {base} route): {res[key]:.4f} ms against "
            f"{res['ms']:.4f} ms on the e4m3 route")
        res["max_abs_err"] = 0.0
        res["base"] = base
        out[label] = res
        del as_base, packed, tables
        torch.cuda.empty_cache()
    return out


def check_sampling_recorded(torch, flush, bw, fp32_rate, cap, name):
    """The sampling forward on one decoder layer's recorded points and the
    stream's ring: bit for bit against the plain version, timed beside the
    bound of these inputs."""
    from sparsebev_tpu_torch.ops.msmv_sampling import (msmv_sampling,
                                                       msmv_sampling_plain)
    packed, loc, sw = cap["sampling"]
    got = msmv_sampling(packed, loc, sw)
    want = msmv_sampling_plain(packed, loc, sw)
    torch.cuda.synchronize()
    if not _bit_equal(torch, got, want):
        fail(f"sampling kernel differs from its plain version on the "
             f"recorded {name} points")
    del got, want
    result = _time_sampling(
        torch, flush, bw, fp32_rate, packed, loc, sw,
        f"{name} recorded points] {str(packed.tables[0].dtype)[6:]}, "
        "bit-equal to plain")
    return dict(result, max_abs_err=0.0)


def _device_kernels(torch, fn):
    """Names of the device kernels one call of ``fn`` launches (a
    torch.profiler trace)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sorted({e.key for e in prof.key_averages()
                   if str(e.device_type).endswith("CUDA") and _dev_us(e) > 0})


def check_attention(torch, dev, flush, bw, fp32_rate, path):
    """The EVA02 attention kernel at the path's two shapes (fp32 q, k, v
    from N(0, 1), 16 heads of 64) against its plain version within
    ``ATTENTION_TOL``, timed with CUDA events beside its bound (three
    products of 4 B H N^2 hd flops at the dense TF32 rate; the one-product
    fp32-FMA bound printed beside it) and beside
    ``F.scaled_dot_product_attention`` on the same tensors (a yardstick the
    package never calls; the kernels it launches are named from a profiler
    trace). Returns one result per shape."""
    import torch.nn.functional as F
    from sparsebev_tpu_torch.ops.eva_attention import (ATTENTION_TOL,
                                                       eva_attention,
                                                       eva_attention_plain)
    gen = torch.Generator(device=dev).manual_seed(4)
    heads, hd = 16, 64
    bf16_rate = peaks(torch.cuda.get_device_name(dev))[2]
    results = {}
    for label, (b, n) in path["attention"].items():
        q, k, v = (torch.randn((b, n, heads, hd), generator=gen, device=dev)
                   for _ in range(3))
        got = eva_attention(q, k, v)
        want = eva_attention_plain(q, k, v)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        lib = F.scaled_dot_product_attention(qt, kt, vt).transpose(1, 2)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        scale = want.abs().max().item()
        lib_err = (lib - want).abs().max().item()
        name = f"{path['name']} {label}"
        log(f"attention [{name}] B={b} N={n} H={heads} hd={hd} fp32: "
            f"max|kernel - plain| = {err:.4g} (output scale {scale:.4g}, "
            f"tolerance {ATTENTION_TOL:g} of it); max|SDPA - plain| = "
            f"{lib_err:.4g}")
        if not err <= ATTENTION_TOL * scale:
            fail(f"attention kernel differs from its plain version ({name})")
        del got, want, lib
        lib_kernels = _device_kernels(
            torch, lambda: F.scaled_dot_product_attention(qt, kt, vt))
        log(f"attention [{name}]: SDPA's device kernels: "
            + "; ".join(lib_kernels))
        ms = time_ms(torch, lambda: eva_attention(q, k, v), 20, flush)
        plain_ms = time_ms(torch, lambda: eva_attention_plain(q, k, v), 5,
                           flush, PLAIN_BUSY_CYCLES)
        library_ms = time_ms(
            torch, lambda: F.scaled_dot_product_attention(qt, kt, vt), 20,
            flush)
        flops = 4 * b * heads * n * n * hd      # one product pair
        nbytes = 4 * q.numel() * q.element_size()
        # three TF32 products at the dense TF32 rate (half the bf16 rate);
        # beside it one fp32 product on the non-tensor-core rate
        bound_ms = max(3 * flops / (bf16_rate / 2), nbytes / bw) * 1e3
        fma_ms = max(flops / fp32_rate, nbytes / bw) * 1e3
        log(f"attention [{name}]: {ms:.4f} ms (plain {plain_ms:.4f} ms, "
            f"SDPA {library_ms:.4f} ms), bound {bound_ms:.4f} ms by "
            f"operations (3xTF32: 3 x {flops / 1e9:.1f} GFLOP at the dense "
            f"TF32 rate; {nbytes / 1e6:.1f} MB): {100 * bound_ms / ms:.1f}% "
            f"of the bound; {flops / ms / 1e9:.2f} TFLOP/s of fp32 work; "
            f"the fp32-FMA bound {fma_ms:.4f} ms ({100 * fma_ms / ms:.1f}%)")
        results[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                             bound_ms=bound_ms, bound_by="operations",
                             library_ms=library_ms, bound_route="3xTF32",
                             fp32_fma_bound_ms=fma_ms,
                             library_kernels=lib_kernels)
        del q, k, v, qt, kt, vt
        torch.cuda.empty_cache()
    return results


# the backward's kernels, by the name each carries in a profiler trace
BACKWARD_KERNELS = dict(eva_attention_delta_kernel="D pass",
                        eva_attention_dkdv_kernel="dK / dV",
                        eva_attention_dq_kernel="dQ")


def backward_kernel_ms(torch, fn, flush, reps=5, tries=3):
    """Device ms of each kernel that one call of ``fn`` launches (the
    attention backward's D pass, dK / dV and dQ), the mean over ``reps``
    calls under torch.profiler, the L2 flushed before each call. The
    profiler now and then records none of a call's kernels: a trace that
    lacks one is taken again, at most ``tries`` times; a kernel missing
    from every trace is left out."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    out = {}
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                flush.zero_()
                torch.cuda._sleep(2_000_000)
                fn()
            torch.cuda.synchronize()
        out = {label: _dev_us(e) / e.count / 1e3
               for e in prof.key_averages()
               for kernel, label in BACKWARD_KERNELS.items()
               if kernel in e.key and e.count == reps and _dev_us(e) > 0}
        if len(out) == len(BACKWARD_KERNELS):
            break
    return out


def check_attention_backward(torch, dev, flush, bw, fp32_rate, shapes):
    """The attention backward kernel at the training step's shapes
    (``shapes``: label -> (batch, tokens); fp32 q, k, v and dO from
    N(0, 1), 16 heads of 64). First the forward with the log-sum-exp
    against its plain versions (``ATTENTION_TOL`` of the output's and of
    the lse's scale); then dq, dk, dv from that output and lse against
    ``eva_attention_backward_plain`` and against autograd of
    ``eva_attention_plain`` on the same inputs, each within
    ``ATTENTION_BWD_TOL`` of its own scale. Timed with CUDA events (L2
    flushed) beside its bounds (five products of 2 B H N^2 hd flops: three
    TF32 products each at the dense TF32 rate, and one fp32-FMA product
    each) and beside the backward of ``F.scaled_dot_product_attention``
    (fp32) on the same tensors, whose kernels are named from a profiler
    trace; the forward with the lse is timed too, and the backward's three
    kernels apart (``backward_kernel_ms``). Two calls on the same inputs
    must give the same bits. Returns one result per shape."""
    import torch.nn.functional as F
    from sparsebev_tpu_torch.ops import eva_attention as ea
    gen = torch.Generator(device=dev).manual_seed(6)
    heads, hd = 16, 64
    tf32_rate = peaks(torch.cuda.get_device_name(dev))[2] / 2
    results = {}
    for key, (b, n) in shapes.items():
        name = f"eva02 train {key}"
        q, k, v, g = (torch.randn((b, n, heads, hd), generator=gen,
                                  device=dev) for _ in range(4))
        out, lse = ea._eva_attention_cuda(q, k, v, with_lse=True)
        want = ea.eva_attention_plain(q, k, v)
        want_lse = ea.eva_attention_lse_plain(q, k)
        torch.cuda.synchronize()
        err_o = (out - want).abs().max().item()
        scale_o = want.abs().max().item()
        err_l = (lse - want_lse).abs().max().item()
        scale_l = want_lse.abs().max().item()
        log(f"attention backward [{name}] B={b} N={n} H={heads} hd={hd} "
            f"fp32: forward with lse: max|out - plain| = {err_o:.4g} (scale "
            f"{scale_o:.4g}), max|lse - plain| = {err_l:.4g} (scale "
            f"{scale_l:.4g}); tolerance {ea.ATTENTION_TOL:g} of each scale")
        if not (err_o <= ea.ATTENTION_TOL * scale_o
                and err_l <= ea.ATTENTION_TOL * scale_l):
            fail(f"the attention forward with lse differs from its plain "
                 f"versions ({name})")
        del want, want_lse
        got = ea._eva_attention_backward_cuda(q, k, v, out, lse, g)
        plain = ea.eva_attention_backward_plain(q, k, v, out, lse, g)
        qa, ka, va = (x.clone().requires_grad_() for x in (q, k, v))
        auto = torch.autograd.grad(ea.eva_attention_plain(qa, ka, va),
                                   (qa, ka, va), g)
        del qa, ka, va
        torch.cuda.synchronize()
        errs, abs_errs, auto_errs, scales = [], [], [], []
        for a, p_, r in zip(got, plain, auto):
            scale = p_.abs().max().item()
            scales.append(scale)
            abs_errs.append((a - p_).abs().max().item())
            errs.append(abs_errs[-1] / scale)
            auto_errs.append((a - r).abs().max().item()
                             / r.abs().max().item())
        log(f"attention backward [{name}]: max|kernel - plain| / scale: dq "
            f"{errs[0]:.3g}, dk {errs[1]:.3g}, dv {errs[2]:.3g} (scales "
            + ", ".join(f"{x:.4g}" for x in scales) + "); against autograd "
            f"of the plain forward: {auto_errs[0]:.3g}, {auto_errs[1]:.3g}, "
            f"{auto_errs[2]:.3g}; tolerance {ea.ATTENTION_BWD_TOL:g}")
        if not max(errs + auto_errs) <= ea.ATTENTION_BWD_TOL:
            fail(f"the attention backward kernel differs from its plain "
                 f"version ({name})")
        again = ea._eva_attention_backward_cuda(q, k, v, out, lse, g)
        if not all(_bit_equal(torch, a, b) for a, b in zip(got, again)):
            fail(f"two calls of the attention backward on the same inputs "
                 f"differ ({name})")
        log(f"attention backward [{name}]: two calls on the same inputs "
            "are bit-equal")
        del got, plain, auto, again
        torch.cuda.empty_cache()
        ms = time_ms(torch, lambda: ea._eva_attention_backward_cuda(
            q, k, v, out, lse, g), 10, flush)
        parts = backward_kernel_ms(
            torch, lambda: ea._eva_attention_backward_cuda(
                q, k, v, out, lse, g), flush)
        fwd_ms = time_ms(torch, lambda: ea._eva_attention_cuda(
            q, k, v, with_lse=True), 10, flush)
        plain_ms = time_ms(torch, lambda: ea.eva_attention_backward_plain(
            q, k, v, out, lse, g), 3, flush, PLAIN_BUSY_CYCLES)
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                      for x in (q, k, v))
        gt = g.transpose(1, 2)
        so = F.scaled_dot_product_attention(qt, kt, vt)

        def library():
            return torch.autograd.grad(so, (qt, kt, vt), gt,
                                       retain_graph=True)

        lib = library()
        lib_err = max((x.transpose(1, 2) - r).abs().max().item()
                      / r.abs().max().item()
                      for x, r in zip(lib, ea.eva_attention_backward_plain(
                          q, k, v, out, lse, g)))
        del lib
        for _ in range(5):      # a trace now and then holds no device op
            lib_kernels = _device_kernels(torch, library)
            if lib_kernels:
                break
        library_ms = time_ms(torch, library, 10, flush)
        del so, qt, kt, vt, gt
        flops = 10 * b * heads * n * n * hd   # five products
        nbytes = 8 * q.numel() * q.element_size() + lse.numel() * 4
        bound_ms = max(3 * flops / tf32_rate, nbytes / bw) * 1e3
        fma_ms = max(flops / fp32_rate, nbytes / bw) * 1e3
        fwd_bound_ms = 3 * (flops * 2 // 5) / tf32_rate * 1e3
        log(f"attention backward [{name}]: SDPA's backward kernels: "
            + "; ".join(lib_kernels) + f"; max|SDPA - plain| / scale "
            f"{lib_err:.3g}")
        log(f"attention backward [{name}]: {ms:.4f} ms (plain {plain_ms:.4f} "
            f"ms, SDPA backward {library_ms:.4f} ms), bound {bound_ms:.4f} ms "
            f"by operations (3xTF32: 3 x {flops / 1e12:.3f} TFLOP at the "
            f"dense TF32 rate; {nbytes / 1e9:.3f} GB at {bw / 1e12:.2f} "
            f"TB/s {nbytes / bw * 1e3:.4f} ms): {100 * bound_ms / ms:.1f}% "
            f"of the bound; the fp32-FMA bound {fma_ms:.4f} ms "
            f"({100 * fma_ms / ms:.1f}%); the forward with lse {fwd_ms:.4f} "
            f"ms (3xTF32 bound {fwd_bound_ms:.4f} ms)")
        log(f"attention backward [{name}]: by kernel (profiler, L2 flushed, "
            "mean of 5 calls): " + ", ".join(
                f"{k} " + (f"{parts[k]:.4f} ms" if k in parts
                           else "not measured")
                for k in BACKWARD_KERNELS.values()))
        results[name] = dict(max_abs_err=max(abs_errs),
                             max_rel_err=max(errs), ms=ms, plain_ms=plain_ms,
                             bound_ms=bound_ms, bound_by="operations",
                             library_ms=library_ms, bound_route="3xTF32",
                             fp32_fma_bound_ms=fma_ms,
                             autograd_rel_err=max(auto_errs),
                             library_kernels=lib_kernels,
                             forward_lse_ms=fwd_ms,
                             forward_bound_ms=fwd_bound_ms,
                             kernel_ms=parts)
        del q, k, v, g, out, lse
        torch.cuda.empty_cache()
    return results


def sass_by_function(text):
    """Tensor-core opcode counts (HMMA, HGMMA) per function of
    ``cuobjdump -sass`` output, keyed by the mangled name of each
    ``Function :`` section."""
    import collections
    counts, fn = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            counts[fn] = collections.Counter()
        elif fn is not None:
            counts[fn].update(re.findall(r"\b(HG?MMA\.[\w.]+)", line))
    return counts


# the attention kernels whose SASS is checked: the forward on TF32 mma.sync
# (HMMA), the backward's two on TF32 wgmma (HGMMA and no HMMA)
ATTENTION_SASS = dict(eva_attention_kernel="HMMA",
                      eva_attention_dkdv_kernel="HGMMA",
                      eva_attention_dq_kernel="HGMMA")


def attention_sass(lib_path):
    """Print the tensor-core opcode counts of each attention kernel in the
    SASS of a built library (``cuobjdump -sass``); fails unless the forward
    holds TF32 HMMA and each backward kernel TF32 HGMMA and no HMMA."""
    from sparsebev_tpu_torch.kernels import build
    tool = os.path.join(os.path.dirname(os.path.realpath(build.find_nvcc())),
                        "cuobjdump")
    out = subprocess.run([tool, "-sass", lib_path], capture_output=True,
                         text=True, timeout=300)
    if out.returncode != 0:
        fail(f"cuobjdump -sass failed: {out.stderr.strip()[:400]}")
    by_fn = sass_by_function(out.stdout)
    for kernel, want in ATTENTION_SASS.items():
        found = [c for f, c in by_fn.items()
                 if re.search(rf"\d{kernel}E", f)]
        if len(found) != 1:
            fail(f"the SASS holds {len(found)} functions named {kernel}")
        counts = found[0]
        log(f"sass[eva_attention]: {kernel}: "
            + (", ".join(f"{k} x {v}" for k, v in sorted(counts.items()))
               or "no tensor-core opcode"))
        tf32 = [k for k in counts
                if k.startswith(want + ".") and "TF32" in k]
        if not tf32:
            fail(f"{kernel}'s SASS holds no TF32 {want}")
        if want == "HGMMA" and any(k.startswith("HMMA.") for k in counts):
            fail(f"{kernel}'s SASS holds HMMA beside its wgmma products")


def attention_ptxas(text):
    """Print what ptxas reports for each attention kernel (registers,
    spills, static shared memory) beside its dynamic shared memory; fails
    if either backward kernel spills."""
    from sparsebev_tpu_torch.ops import eva_attention as ea
    dynamic = ea.kernel_smem_bytes()
    for r in ptxas_report(text):
        log(f"ptxas[eva_attention]: {r['kernel']}: {r['regs']} registers, "
            f"spills {r['spill_stores']} / {r['spill_loads']} bytes (stores "
            f"/ loads), {r['stack']} bytes stack frame, {r['smem']} bytes "
            f"static and {dynamic.get(r['kernel'], 0)} bytes dynamic shared "
            "memory")
        if r["kernel"] in ("eva_attention_dkdv_kernel",
                           "eva_attention_dq_kernel") and \
                (r["spill_stores"] or r["spill_loads"]):
            fail(f"{r['kernel']} spills registers")


# the fp32 conv against the CPU: fp32 sums of C_in * 9 = 2,304 products in
# another order than the fp64 CPU reference, a few fp32 roundings of values
# up to the output scale, hence 1e-5 of its max abs; TF32 operands (10-bit
# mantissas) miss it by tens of times (3.9e-4 of the scale on an H100)
CONV_FP32_TOL = 1e-5


def check_fp32_conv(torch, dev):
    """A ResNet-50 stage conv of the r50 config in fp32 (layer3's first 3x3,
    stride 2, 256 channels, folded with its BN), recorded on the frame pass
    (``forward_frame_packed`` of one 6-view frame at 704x256, seeded
    weights) with the process-wide cuDNN conv precision "tf32": its output
    against the same conv on the CPU in fp64 within ``CONV_FP32_TOL`` of the
    scale.
    The same operands through cuDNN with TF32 allowed give the error the
    port's scope removes (printed)."""
    import torch.nn.functional as F
    from sparsebev_tpu_torch.config import Config
    from sparsebev_tpu_torch.models.detector import build_detector
    cfg = Config.fromfile(os.path.join(HERE, PATHS[0]["config"]))
    cfg.model["compute_dtype"] = "float32"
    image_h, image_w = cfg.ida_aug_conf["final_dim"]
    model = build_detector(cfg, device=dev, seed=0)
    block = model.img_backbone.layer3[0]
    cbn = block._cbn[1]
    seen = {}

    def record(x):
        w, t = cbn._folded(x.dtype, x.device)
        seen.update(x=x.clone(), w=w.clone(), t=t.clone(),
                    flag=torch.backends.cudnn.conv.fp32_precision)
        out = cbn(x)
        seen["out"] = out.clone()
        return out

    saved = torch.backends.cudnn.conv.fp32_precision
    torch.backends.cudnn.conv.fp32_precision = "tf32"
    block._cbn[1] = record
    try:
        gen = torch.Generator().manual_seed(7)
        img = torch.randint(0, 256, (1, 6, image_h, image_w, 3),
                            generator=gen, dtype=torch.uint8).to(dev)
        with torch.inference_mode():
            model.forward_frame_packed(img)
            conv = cbn._conv
            args = (conv.stride, conv.padding)
            tf32 = F.conv2d(seen["x"], seen["w"], seen["t"], *args)
            torch.cuda.synchronize()
        ref = F.conv2d(seen["x"].cpu().double(), seen["w"].cpu().double(),
                       seen["t"].cpu().double(), *args)
    finally:
        block._cbn[1] = cbn
        torch.backends.cudnn.conv.fp32_precision = saved
    scale = ref.abs().max().item()
    err = (seen["out"].cpu().double() - ref).abs().max().item()
    tf32_err = (tf32.cpu().double() - ref).abs().max().item()
    log(f"fp32 conv [r50 layer3.0.conv2, {tuple(seen['x'].shape)} -> "
        f"{tuple(ref.shape)}]: cuDNN conv precision inside the frame pass "
        f"{seen['flag']} (process-wide tf32); max|card - CPU fp64| = "
        f"{err:.4g} ({err / scale:.3g} of the scale {scale:.4g}, tolerance "
        f"{CONV_FP32_TOL:g}); with TF32 allowed {tf32_err:.4g} "
        f"({tf32_err / scale:.3g} of the scale)")
    if seen["flag"] != "ieee" or not err <= CONV_FP32_TOL * scale:
        fail("the frame pass's fp32 conv did not run in fp32")
    del model
    torch.cuda.empty_cache()


# ------------------------------------------------ the trunk's products --

# the EVA02 trunk's product shapes (M, N, K) at 1600x640 and their calls a
# frame pass (168 in all)
LINEAR_SHAPES = (("global q / k / v / proj", (24000, 1024, 1024), 32),
                 ("windowed q / k / v / proj", (32256, 1024, 1024), 64),
                 ("w1 / w2", (24000, 2730, 1024), 48),
                 ("w3", (24000, 1024, 2730), 24))
# small shapes no config has, for the kernel's edges: a ragged M, N and K on
# both load routes (a k-tail on TMA, an odd number of 8-byte pieces a row
# on cp.async), no bias, and x 8 bytes off its 16-byte alignment (label,
# (M, N, K), bias, x's offset in floats)
LINEAR_EDGES = (("ragged, TMA", (300, 2730, 1000), True, 0),
                ("ragged, cp.async", (300, 1030, 2730), False, 0),
                ("odd M, cp.async", (1001, 130, 2730), True, 0),
                ("tiny, cp.async", (5, 2, 6), True, 0),
                ("x off 16-byte alignment", (257, 1024, 1024), True, 2))


def linear_ptxas(text, lib_path):
    """Print what ptxas reports for the product kernel's two instantiations
    (registers, spills, shared memory) and its tensor-core opcodes in the
    SASS; fails if it spills, or holds no TF32 HGMMA or any HMMA."""
    from sparsebev_tpu_torch.kernels import build
    from sparsebev_tpu_torch.ops import eva_linear as el
    dynamic = el.kernel_smem_bytes()
    for r in ptxas_report(text):
        log(f"ptxas[eva_linear]: {r['kernel']}: {r['regs']} registers, "
            f"spills {r['spill_stores']} / {r['spill_loads']} bytes (stores "
            f"/ loads), {r['stack']} bytes stack frame, {r['smem']} bytes "
            f"static and {dynamic} bytes dynamic shared memory")
        if r["spill_stores"] or r["spill_loads"]:
            fail(f"{r['kernel']} spills registers")
    for line in text.splitlines():
        if "wgmma" in line.lower() or "warning" in line.lower():
            log(f"build[eva_linear]: {line.strip()}")
    tool = os.path.join(os.path.dirname(os.path.realpath(build.find_nvcc())),
                        "cuobjdump")
    out = subprocess.run([tool, "-sass", lib_path], capture_output=True,
                         text=True, timeout=300)
    if out.returncode != 0:
        fail(f"cuobjdump -sass failed: {out.stderr.strip()[:400]}")
    found = [(f, c) for f, c in sass_by_function(out.stdout).items()
             if "eva_linear_kernel" in f]
    if len(found) != 2:                 # one a load route
        fail(f"the SASS holds {len(found)} functions named eva_linear_kernel")
    for f, counts in found:
        log(f"sass[eva_linear]: {f}: "
            + (", ".join(f"{k} x {v}" for k, v in sorted(counts.items()))
               or "no tensor-core opcode"))
        if not any(k.startswith("HGMMA.") and "TF32" in k for k in counts) \
                or any(k.startswith("HMMA.") for k in counts):
            fail(f"{f}'s SASS holds no TF32 HGMMA, or HMMA beside it")


def _linear_operands(torch, dev, m, n, k, bias=True, offset=0, seed=9):
    """x from N(0, 1), W and b as ``nn.Linear`` draws them (uniform within
    1/sqrt(K)); x starts ``offset`` floats into its storage."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(m * k + offset, generator=gen, device=dev)[offset:]
    bound = k ** -0.5
    w = (torch.rand((n, k), generator=gen, device=dev) * 2 - 1) * bound
    b = ((torch.rand(n, generator=gen, device=dev) * 2 - 1) * bound
         if bias else None)
    return x.view(m, k), w, b


def _fp64_gap(torch, got, x, w, b):
    """max|got - x W^T - b| over the max abs of the fp64 product, with the
    product in fp64 on the card."""
    want = x.double() @ w.double().t()
    if b is not None:
        want += b.double()
    return ((got.double() - want).abs().max() / want.abs().max()).item()


def check_linear(torch, dev, flush, bw, fp32_rate, shapes=LINEAR_SHAPES,
                 edges=LINEAR_EDGES):
    """The trunk's product kernel (``ops/eva_linear.py``): at the edge
    shapes, and at the trunk's four shapes, against the fp64 product within
    ``LINEAR_TOL`` of its max abs (fp32 ``F.linear``'s gap printed beside
    it) and bit-equal to itself on a second call; at the trunk's shapes
    timed with the L2 flushed beside fp32 ``F.linear`` (the plain version,
    the FMA route on this card) and its bound (three TF32 products of
    2 M N K flops at the dense TF32 rate, or its bytes; the one-product
    fp32-FMA bound beside it). Returns one result per trunk shape."""
    import torch.nn.functional as F
    from sparsebev_tpu_torch.ops import eva_linear as el
    bf16_rate = peaks(torch.cuda.get_device_name(dev))[2]
    log(f"linear: torch.backends.cuda.matmul.fp32_precision = "
        f"{torch.backends.cuda.matmul.fp32_precision}; kernel shared memory "
        f"{el.kernel_smem_bytes()} bytes")
    cases = [(label, shape, bias, offset, None)
             for label, shape, bias, offset in edges]
    cases += [(label, shape, True, 0, calls) for label, shape, calls in shapes]
    results = {}
    for label, (m, n, k), bias, offset, calls in cases:
        x, w, b = _linear_operands(torch, dev, m, n, k, bias, offset)
        got = el.eva_linear(x, w, b)
        again = el.eva_linear(x, w, b)
        plain = F.linear(x, w, b)
        gap = _fp64_gap(torch, got, x, w, b)
        plain_gap = _fp64_gap(torch, plain, x, w, b)
        same = _bit_equal(torch, got, again)
        route = el.load_route(x, w)
        log(f"linear [{label}] M={m} N={n} K={k} "
            f"{'bias' if bias else 'no bias'}, {route}: max|kernel - fp64| "
            f"= {gap:.3g} of the scale (tolerance {el.LINEAR_TOL:g}), fp32 "
            f"F.linear {plain_gap:.3g}; bit-equal on a second call: {same}")
        if not (gap <= el.LINEAR_TOL and same):
            fail(f"the product kernel misses its fp64 product ({label})")
        del got, again, plain
        if calls is None:
            continue
        ms = time_ms(torch, lambda: el.eva_linear(x, w, b), 20, flush)
        plain_ms = time_ms(torch, lambda: F.linear(x, w, b), 20, flush)
        flops = 2 * m * n * k
        nbytes = 4 * (m * k + n * k + m * n + n)
        bound_ms = max(3 * flops / (bf16_rate / 2), nbytes / bw) * 1e3
        fma_ms = max(flops / fp32_rate, nbytes / bw) * 1e3
        log(f"linear [{label}]: {ms:.4f} ms (plain F.linear {plain_ms:.4f} "
            f"ms), bound {bound_ms:.4f} ms by operations (3xTF32: 3 x "
            f"{flops / 1e12:.3f} TFLOP at the dense TF32 rate; "
            f"{nbytes / 1e6:.1f} MB): {100 * bound_ms / ms:.1f}% of the "
            f"bound, {3 * flops / ms / 1e9:.1f} TFLOP/s of TF32 products; "
            f"the fp32-FMA bound {fma_ms:.4f} ms; {calls} calls a frame: "
            f"{calls * ms:.2f} ms against {calls * plain_ms:.2f}")
        results[label] = dict(max_abs_err=gap, plain_gap=plain_gap, ms=ms,
                              plain_ms=plain_ms, bound_ms=bound_ms,
                              bound_by="operations", library_ms=None,
                              bound_route="3xTF32", fp32_fma_bound_ms=fma_ms,
                              route=route, calls_a_frame=calls)
        del x, w, b
        torch.cuda.empty_cache()
    return results


def bringup_linear(gate=True):
    """The trunk's product kernel alone: build it, print what ptxas reports
    (failing on spills) and its SASS's tensor-core opcodes, run
    ``check_linear``, then (``gate``) the EVA02 trunk gates in bf16 (held)
    and fp32 (printed) (``python3 -c "import chip_smoke;
    chip_smoke.bringup_linear()"``)."""
    import torch
    sys.path.insert(0, HERE)
    from sparsebev_tpu_torch.kernels import build
    dev = torch.device("cuda", 0)
    log(nvidia_smi_line())
    logs = build.build_all(["eva_linear"] + (["eva_attention"] if gate
                                             else []))
    linear_ptxas(logs["eva_linear"], build.library_path("eva_linear"))
    bw, fp32_rate, _ = peaks(torch.cuda.get_device_name(0))
    flush = torch.empty(64 * 2**20, dtype=torch.int32, device=dev)
    check_linear(torch, dev, flush, bw, fp32_rate)
    del flush
    torch.cuda.empty_cache()
    if gate:
        path = next(p for p in PATHS if p["name"] == "eva02")
        eva02_trunk_gate(torch, dev, path)                  # held
        eva02_trunk_gate(torch, dev, path, "float32")       # printed

# ------------------------------------------------------------- phase 4 --

def make_cameras(rng, image_h, image_w, n=6):
    """Six outward-facing pinhole cameras near the origin (lidar2img)."""
    import numpy as np
    mats = []
    for i in range(n):
        yaw = 2 * np.pi * i / n + rng.uniform(-0.1, 0.1)
        cy, sy = np.cos(yaw), np.sin(yaw)
        r_wc = np.array([[-sy, cy, 0.0], [0.0, 0.0, -1.0], [cy, sy, 0.0]])
        t = rng.uniform(-0.5, 0.5, 3)
        rt = np.eye(4)
        rt[:3, :3] = r_wc
        rt[:3, 3] = -r_wc @ t
        k = np.eye(4)
        f = image_w * 0.8
        k[0, 0], k[1, 1] = f, f
        k[0, 2], k[1, 2] = image_w / 2, image_h / 2
        mats.append((k @ rt).astype(np.float32))
    return np.stack(mats)


def make_stream(num_samples, num_frames, image_h, image_w, seed=0):
    """Synthetic 6-camera stream: sample i holds frames i, i-1, ... (the
    first frame repeated at the start, as the loader pads history); only the
    newest frame's pixels are passed, older ones must be cached."""
    import numpy as np
    rng = np.random.default_rng(seed)
    cams = make_cameras(np.random.RandomState(seed), image_h, image_w)
    frames = rng.integers(0, 256, (num_samples, 1, 6, image_h, image_w, 3),
                          dtype=np.uint8)
    l2i = np.tile(cams[None], (1, num_frames, 1, 1)).reshape(
        1, num_frames * 6, 4, 4)
    td = (np.arange(num_frames, dtype=np.float32) * 0.5)[None]
    samples = []
    for i in range(num_samples):
        ids = [max(i - j, 0) for j in range(num_frames)]
        names = [f"/data/sweeps/CAM_{v}/frame{j:04d}.jpg" for j in ids
                 for v in range(6)]
        samples.append((frames[i], l2i, td, names))
    return samples


def run_stream(torch, det, samples, prefetch=True):
    """Drive ``det.infer`` over the stream; returns per-sample ms and the
    raw predictions."""
    times, preds = [], []
    for i, s in enumerate(samples):
        if prefetch and i + 1 < len(samples):
            det.prefetch_upload(samples[i + 1][0], samples[i + 1][3])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = det.infer(*s)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        preds.append({k: v[-1].float().clone() for k, v in out.items()})
    return times, preds


def _dev_us(e):
    """Device time of a profiler row, under either name torch gives it."""
    v = getattr(e, "self_device_time_total", None)
    return v if v is not None else e.self_cuda_time_total


def device_ops(torch, fn, kernels, tries=5):
    """Device operations (kernels, copies, memsets) that one call of ``fn``
    puts on the card, counted from a torch.profiler trace of a later call,
    and the launches that the wrappers in ``kernels`` counted in that call.
    torch.profiler on the H100 host now and then records none of a short
    call's device ops (0 ops for a 0.1 ms call whose wrappers counted 2
    launches, at times in each of five traces in a row), so the trace
    stays open for a pause of the host before and after the call, and a
    trace that holds fewer device ops than the counted launches, or none,
    is taken again, at most ``tries`` times. Returns (ops or None if every trace fell short,
    launches)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        before = sum(k.launches for k in kernels)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            time.sleep(0.05)
            fn()
            torch.cuda.synchronize()
            time.sleep(0.2)
        launched = sum(k.launches for k in kernels) - before
        ops = sum(e.count for e in prof.key_averages()
                  if _dev_us(e) > 0 and str(e.device_type).endswith("CUDA"))
        if ops >= max(launched, 1):
            return ops, launched
    return None, launched


def breakdown(torch, det, samples, frame_label):
    """Where a streaming sample's time goes: the frame pass and the head
    timed apart (host clock, synchronized), and a torch.profiler trace of
    a few samples (device busy time, kernel launches, top kernels)."""
    from torch.profiler import ProfilerActivity, profile
    from sparsebev_tpu_torch.ops.msmv_sampling import ring_packed

    m, t = det.model, det.num_frames
    frame = torch.from_numpy(samples[0][0]).to(det.device)
    image_h, image_w = frame.shape[2], frame.shape[3]
    l2i = torch.as_tensor(samples[0][1], device=det.device)
    td = torch.as_tensor(samples[0][2], device=det.device)
    slots = torch.arange(t, device=det.device)

    def frame_pass():
        m.forward_frame_packed(frame)

    def head_pass():
        m.forward_head(ring_packed(det.ring, slots, t, det._meta), l2i, td,
                       image_h, image_w)

    def first_sample_frames():
        for _ in range(t):
            frame_pass()

    split = {}
    with torch.inference_mode():
        for name, fn in ((f"frame pass ({frame_label})", frame_pass),
                         ("head (6 decoder layers, 6 sampling calls)",
                          head_pass)):
            reps = []
            for _ in range(6):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                reps.append((time.perf_counter() - t0) * 1e3)
            split[name] = statistics.median(reps[1:])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        first_sample_frames()
        torch.cuda.synchronize()
        first = (time.perf_counter() - t0) * 1e3
    log("breakdown: " + "; ".join(f"{k} {v:.3f} ms" for k, v in split.items())
        + f" (median of 5, host clock); a first sample's {t} frame passes "
        f"back to back {first:.3f} ms (host clock, synchronized at the end)")

    with torch.inference_mode(), profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for s in samples:
            det.infer(*s)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / len(samples)

    events = [e for e in prof.key_averages() if _dev_us(e) > 0]
    # device-side rows are the kernels and copies themselves; host-side rows
    # are the aten ops that launched them (the ctypes kernels have none)
    device = [e for e in events if str(e.device_type).endswith("CUDA")]
    if not device:
        log("breakdown: the profiler recorded no device time")
        return
    n = len(samples)
    busy = sum(_dev_us(e) for e in device) / 1e3 / n
    launches = sum(e.count for e in device) / n
    log(f"breakdown: {n} new-frame samples under torch.profiler: wall "
        f"{wall:.3f} ms/sample, device busy {busy:.3f} ms/sample "
        f"({100 * busy / wall:.1f}%; idle {100 * (1 - busy / wall):.1f}%), "
        f"{launches:.0f} device ops/sample")
    host = [e for e in events if e not in device]
    top = sorted(host, key=_dev_us, reverse=True)[:10] + \
        [e for e in device if "msmv" in e.key or "eva_attention" in e.key]
    for e in top:
        log(f"breakdown: {_dev_us(e) / 1e3 / n:8.4f} ms/sample "
            f"{e.count / n:6.1f} calls/sample  {e.key[:70]}")


@contextlib.contextmanager
def plain_versions():
    """Route the CUDA branch of the pack, sampling, one-hot, attention
    (forward and backward) and trunk product wrappers to their plain
    PyTorch versions (on the card) for the duration."""
    import torch.nn.functional as F
    from sparsebev_tpu_torch.ops import (eva_attention, eva_linear,
                                         msmv_onehot, msmv_pack,
                                         msmv_sampling)
    def attention(q, k, v, with_lse=False):
        out = eva_attention.eva_attention_plain(q, k, v)
        return out, (eva_attention.eva_attention_lse_plain(q, k)
                     if with_lse else None)

    routes = (
        (eva_attention, "_eva_attention_cuda", attention),
        (eva_linear, "_eva_linear_cuda", F.linear),
        (eva_attention, "_eva_attention_backward_cuda",
         eva_attention.eva_attention_backward_plain),
        (msmv_pack, "_pack_level_cuda", msmv_pack.pack_level_plain),
        (msmv_pack, "_pack_level_pair_cuda", msmv_pack.pack_level_pair_plain),
        (msmv_pack, "_pack_level_bwd_cuda", msmv_pack.pack_level_bwd_plain),
        (msmv_pack, "_pack_level_pair_bwd_cuda",
         msmv_pack.pack_level_pair_bwd_plain),
        (msmv_sampling, "_msmv_sampling_cuda",
         msmv_sampling.msmv_sampling_plain),
        (msmv_sampling, "_msmv_sampling_backward_cuda",
         msmv_sampling.msmv_sampling_backward_plain),
        (msmv_onehot, "_onehot_cuda", msmv_onehot.onehot_sample_level_plain),
        (msmv_onehot, "_onehot_levels_cuda",
         msmv_onehot.onehot_sample_levels_plain))
    saved = [getattr(mod, name) for mod, name, _ in routes]
    for mod, name, plain in routes:
        setattr(mod, name, plain)
    try:
        yield
    finally:
        for (mod, name, _), fn in zip(routes, saved):
            setattr(mod, name, fn)


def capture_inputs(torch, det, model, stream, path):
    """Inputs of phase 5, from one more sample of ``path``'s stream (the
    last one streamed, its frames already in the ring): the operands
    ``(x, m, s)`` of its first ``AdaptiveMixing`` call, recorded by a
    forward hook as the layer computes them; for the hybrid source path
    also its first sampling call (the ring view, query-major locations and
    weights) and its T frames of FPN maps (``[T, N, H, W, C]`` per level,
    the frame pass run again on those frames' pixels)."""
    from sparsebev_tpu_torch.models.decoder import AdaptiveMixing
    from sparsebev_tpu_torch.ops import projection

    mixer = next(mod for mod in model.modules()
                 if isinstance(mod, AdaptiveMixing))
    cap = {}

    def hook(mod, inputs, _out):
        if "mixing" in cap:
            return
        x, query = inputs
        b, q, g, p, c = x.shape
        params = mod.parameter_generator(query).reshape(
            b * q, g, mod.m_params + mod.s_params)
        cap["mixing"] = (
            x.reshape(b * q, g, p, c).to(query.dtype).contiguous(),
            params[..., :mod.m_params].reshape(b * q, g, c, c).contiguous(),
            params[..., mod.m_params:].reshape(
                b * q, g, mod.out_points, mod.in_points).contiguous())

    sampling = projection.msmv_sampling

    def record(packed, loc, sw, *a, **k):
        cap.setdefault("sampling", (packed, loc.clone(), sw.clone()))
        return sampling(packed, loc, sw, *a, **k)

    source = path.get("hybrid_source", False)
    handle = mixer.register_forward_hook(hook)
    if source:
        projection.msmv_sampling = record
    # a replayed CUDA graph calls no module hook: this sample runs eagerly
    det._head = det._eager_head
    try:
        det.infer(*stream[-1])
    finally:
        handle.remove()
        projection.msmv_sampling = sampling
        del det._head
    if not source:
        return cap
    last = len(stream) - 1
    with torch.inference_mode():
        frames = [model.extract_feat(model.preprocess(torch.from_numpy(
            stream[max(last - j, 0)][0]).to(det.device)))
            for j in range(det.num_frames)]
    cap["fpn"] = [torch.stack([f[lvl][0] for f in frames])
                  for lvl in range(len(frames[0]))]
    return cap


def streaming_phase(torch, dev, path):
    """Stream ``path``'s config at full width; returns the launch count of
    every kernel in this run, the median ms/sample and the inputs that
    :func:`capture_inputs` recorded."""
    from sparsebev_tpu_torch.bbox.nms_free_coder import build_coder
    from sparsebev_tpu_torch.config import Config
    from sparsebev_tpu_torch.inference import StreamingDetector
    from sparsebev_tpu_torch.models.detector import build_detector
    from sparsebev_tpu_torch.ops import (eva_attention, eva_linear,
                                         msmv_pack, msmv_sampling,
                                         projection)

    config = os.path.join(HERE, path["config"])
    if not os.path.isfile(config):
        fail(f"missing {config}")
    cfg = Config.fromfile(config)
    cfg.model.update(path.get("model_overrides", {}))
    cfg.model["pts_bbox_head"].update(path.get("head_overrides", {}))
    head = cfg.model["pts_bbox_head"]
    t = head["num_frames"]
    image_h, image_w = cfg.ida_aug_conf["final_dim"]
    num_samples = path["samples"]
    name = path["name"]
    # device memory that earlier phases still hold (the inputs recorded for
    # phase 5): the path's peak is counted above it
    held = torch.cuda.memory_allocated(dev)
    model = build_detector(cfg, device=dev, seed=0)
    coder = build_coder(cfg)
    stream = make_stream(num_samples + PROFILE_SAMPLES, t, image_h, image_w)
    samples = stream[:num_samples]
    backbone = cfg.model["img_backbone"]
    label = (f"{backbone.get('spec_name', backbone['type'])} "
             f"{backbone.get('depth', '')}".strip())
    log(f"streaming [{name}]: {config} ({label}, Q={head['num_query']}, "
        f"T={t}, {image_w}x{image_h}, {head['num_levels']} levels, "
        f"{head['num_layers']} layers, {cfg.model['compute_dtype']}), "
        f"{num_samples} samples")

    counters = dict(pack=msmv_pack.pack_level,
                    pack_pair=msmv_pack.pack_level_pair,
                    sampling=msmv_sampling.msmv_sampling,
                    attention=eva_attention.eva_attention,
                    linear=eva_linear.eva_linear)
    det = StreamingDetector(model, num_frames=t, device=dev)
    torch.cuda.reset_peak_memory_stats(dev)
    with torch.inference_mode():
        for c in counters.values():
            c.launches = 0
        msmv_sampling.msmv_sampling.e4m3_launches = 0
        msmv_sampling.msmv_sampling.e4m3_fp32_launches = 0
        msmv_sampling.msmv_sampling.split_launches = 0
        times, preds = run_stream(torch, det, samples)
        launches = {k: c.launches for k, c in counters.items()}
        # the sampling launches that read an e4m3 level beside bf16 levels,
        # beside fp32 levels, and those that read a chunk-split level,
        # counted apart
        launches["sampling_e4m3"] = msmv_sampling.msmv_sampling.e4m3_launches
        launches["sampling_e4m3_fp32"] = \
            msmv_sampling.msmv_sampling.e4m3_fp32_launches
        launches["sampling_split"] = \
            msmv_sampling.msmv_sampling.split_launches
    peak = torch.cuda.max_memory_allocated(dev) - held
    log(f"streaming [{name}]: kernel launches "
        + " ".join(f"{k}={v}" for k, v in launches.items()))
    for k in path["kernels"]:
        if launches[k] <= 0:
            fail(f"kernel {k} of the {name} path was never launched")
    for i, pr in enumerate(preds):
        if not all(bool(torch.isfinite(v).all()) for v in pr.values()):
            fail(f"non-finite predictions at sample {i}")
    cls, box = preds[-1]["all_cls_scores"], preds[-1]["all_bbox_preds"]
    if tuple(cls.shape) != (1, head["num_query"], head["num_classes"]) \
            or tuple(box.shape) != (1, head["num_query"], 10):
        fail(f"unexpected output shapes {tuple(cls.shape)} {tuple(box.shape)}")
    with torch.inference_mode():
        dec = coder.decode({"all_cls_scores": cls[None],
                            "all_bbox_preds": box[None]})
    if not bool(torch.isfinite(dec["bboxes"]).all()):
        fail("non-finite decoded boxes")
    steady = times[1:]
    ms = statistics.median(steady)
    log(f"streaming [{name}]: per-sample ms "
        + " ".join(f"{x:.2f}" for x in times))
    log(f"streaming [{name}]: median {ms:.3f} ms/sample over samples "
        f"1..{len(times) - 1} ({1e3 / ms:.2f} FPS); sample 0 "
        f"{times[0]:.1f} ms; peak memory {peak / 2**30:.2f} GiB (above "
        f"{held / 2**30:.2f} GiB held by earlier phases); "
        f"{int(dec['mask'].sum())} of {dec['mask'].numel()} decoded boxes "
        "pass the score threshold")
    log(f"streaming [{name}]: head calls {det.head_eager_calls} eager "
        f"(a graph set's warm-up among them), {det.head_captures} "
        f"captured as CUDA graphs, {det.head_replays} replayed")
    compare_with_plain(torch, dev, path, model, det, samples, preds)
    split = (check_split_stream(torch, dev, path, model, det, samples)
             if det._split_mode else None)
    modes = "".join("y" if yf else "p" for yf in model.pts_bbox_head
                    .table_yfold)
    neck = "its pyramid" if cfg.model.get("img_neck") is None else "FPN"
    if path.get("breakdown", True):
        breakdown(torch, det, stream[num_samples:],
                  f"normalize, {label}, {neck}, packs {modes}")
    captured = (capture_inputs(torch, det, model, stream, path)
                if path.get("capture", True) else {})
    if split is not None:
        captured["split"] = split
    del det
    del model, preds
    torch.cuda.empty_cache()
    return launches, ms, captured


# kernel run vs plain run: 5% of the scale (PERF.md section 2)
STREAM_TOL = 5e-2
# share of the ring's entries the amplification probe moves by one ulp
NUDGE_SHARE = 1e-5


def replay_head(torch, dev, model, det, ring, samples):
    """The head alone over each sample of ``samples`` with the frames read
    from ``ring`` (a ring laid out as ``det``'s, which holds every frame of
    them): a detector whose ring already caches every frame."""
    from sparsebev_tpu_torch.inference import StreamingDetector
    rep = StreamingDetector(model, num_frames=det.num_frames, device=dev)
    # compare_with_plain records every call of the projection (and syncs
    # there), which a replayed CUDA graph would skip: the head runs eagerly
    rep._head = rep._eager_head
    rep.ring, rep._meta = ring, det._meta
    rep.slot_of_key = type(det.slot_of_key)(det.slot_of_key)
    _, out = run_stream(torch, rep, samples, prefetch=False)
    if rep.frames_run:
        fail("the head replay ran a frame pass")
    return out


def _output_gap(torch, preds, other):
    """Worst max-abs difference over the samples and both outputs, as a
    share of the ``STREAM_TOL`` tolerance, and whether all are bit-equal."""
    worst, exact = 0.0, True
    for key in ("all_cls_scores", "all_bbox_preds"):
        for a, b in zip(preds, other):
            d = (a[key] - b[key]).abs().max().item()
            worst = max(worst, d / (STREAM_TOL * max(1.0, b[key].abs().max()
                                                     .item())))
            exact = exact and torch.equal(a[key], b[key])
    return worst, exact


def _flipped_queries(calls, other, samples):
    """The discrete choice of the head: ``project_points_qmajor`` picks one
    view a sampling point (the first that sees it) and drops a point no view
    sees, so a point at an image's edge jumps between views or in and out of
    them. ``calls`` and ``other`` hold, for each call of two runs over the
    same samples (one call a decoder layer), the chosen view plus twice the
    valid flag ``[Q, B*G*T, P]``. Returns, per sample, a ``[Q]`` mask of the
    queries whose choice differs at some point of some layer, and the count
    of queries whose first difference is at each layer."""
    if len(calls) != len(other) or len(calls) % samples:
        fail(f"the two runs made {len(calls)} and {len(other)} projection "
             f"calls over {samples} samples")
    layers = len(calls) // samples
    masks, first = [], [0] * layers
    for i in range(samples):
        seen = None
        for lvl in range(layers):
            a, b = calls[i * layers + lvl], other[i * layers + lvl]
            diff = (a != b).flatten(1).any(1)
            new = diff if seen is None else diff & ~seen
            first[lvl] += int(new.sum().item())
            seen = diff if seen is None else seen | diff
        masks.append(seen)
    return masks, first


def _agreeing_gap(preds, other, masks):
    """``_output_gap`` over the queries whose choices agree (``masks`` the
    flipped ones, per sample), and over the flipped ones."""
    agree, flip = 0.0, 0.0
    for key in ("all_cls_scores", "all_bbox_preds"):
        for a, b, m in zip(preds, other, masks):
            tol = STREAM_TOL * max(1.0, b[key].abs().max().item())
            d = (a[key] - b[key]).abs().amax(-1)            # [B, Q]
            agree = max(agree, d[:, ~m].max().item() / tol if
                        bool((~m).any()) else 0.0)
            flip = max(flip, d[:, m].max().item() / tol if bool(m.any())
                       else 0.0)
    return agree, flip


def _level_tensor(torch, level):
    """A ring level as one tensor (a split level's chunks, in order, hold
    the unsplit level's rows)."""
    return torch.cat(level) if isinstance(level, tuple) else level


def _replayable(det, samples):
    """The samples a head replay over ``det``'s ring can run: every frame
    cached and, on a chunk-split ring, no frame twice in the window (the
    replay would copy it into a slot of the ring it shares with ``det``)."""
    keep = []
    for i, s in enumerate(samples):
        keys = det._keys(s[3], len(s[3]) // det.num_views)
        if all(k in det.slot_of_key for k in keys) and (
                not det._split_mode or len(set(keys)) == len(keys)):
            keep.append(i)
    return keep


def compare_with_plain(torch, dev, path, model, det, samples, preds):
    """The kernel run (``det`` right after it, ``preds``) against the same
    stream with the plain versions of every kernel on the card (including
    the frame pass's: the packs and the EVA02 attention):

    - the ring, every table the head reads, within ``STREAM_TOL`` of each
      level's scale (the path's ``ring_tol`` where it gives one);
    - the head replayed with the plain versions over the kernel run's ring
      within ``STREAM_TOL`` of the output scale;
    - the head replayed with the kernels over the kernel run's ring, bit-
      equal to the kernel run, recording each layer's view choice
      (``_flipped_queries``);
    - the two runs' outputs within ``STREAM_TOL`` on paths whose kernels
      all give their plain versions' bits (``exact``, the default). The
      EVA02 attention sums in another order than its plain version, so the
      rings differ in rounding, and the seeded head amplifies that past the
      tolerance, in bf16 and in fp32: there the difference is printed, over
      all queries, over those whose view choices differ in some layer of
      the two runs and over those whose choices agree;
    - the probe: ``NUDGE_SHARE`` of the ring's entries moved by one ulp,
      the last sample's head run with the kernels on it, the change of its
      outputs as a share of the tolerance (how far the seeded head
      amplifies a rounding of its input), split the same way.

    The head replays run over the samples whose frames the ring still holds
    (``_replayable``: on a chunk-split ring of T slots, the last ones, whose
    windows hold T distinct frames); the ring is compared level by level,
    a split level's chunks in order."""
    from sparsebev_tpu_torch.inference import StreamingDetector
    from sparsebev_tpu_torch.ops import projection
    name, t = path["name"], det.num_frames
    project = projection.project_points_qmajor
    valid, calls = [], []

    def project_and_record(*a, **k):
        loc, v = project(*a, **k)
        valid.append(v.mean().item())
        calls.append(loc[..., 2] + 2 * v)
        return loc, v

    projection.project_points_qmajor = project_and_record
    try:
        with plain_versions():
            plain_det = StreamingDetector(model, num_frames=t, device=dev)
            plain_det._head = plain_det._eager_head   # as in replay_head
            _, plain_preds = run_stream(torch, plain_det, samples,
                                        prefetch=False)
        plain_calls, calls = calls, []
        log(f"streaming [{name}]: share of sampling points that land in a "
            f"view: {statistics.mean(valid):.3f}")
        if statistics.mean(valid) < 0.2:
            fail("too few sampling points land in a camera view")
        if list(plain_det.slot_of_key.items()) != \
                list(det.slot_of_key.items()):
            fail("the plain run laid out its ring otherwise")
        ring_exact = True
        for lvl, (a, b) in enumerate(zip(det.ring, plain_det.ring)):
            a, b = _level_tensor(torch, a), _level_tensor(torch, b)
            d = (a.float() - b.float()).abs()
            scale = max(1.0, b.float().abs().max().item())
            same = _bit_equal(torch, a, b)
            ring_exact = ring_exact and same
            log(f"streaming [{name}]: ring level {lvl} {tuple(a.shape)}, "
                f"kernel vs plain run: max abs diff {d.max().item():.4g} "
                f"(scale {scale:.4g}), "
                f"{100 * (d > 0).float().mean().item():.4f}% of the entries "
                f"differ; bit-equal: {same}")
            if not d.max().item() <= path.get("ring_tol", STREAM_TOL) * scale:
                fail(f"the kernel run's ring differs from the plain run's at "
                     f"level {lvl}")
            del d, a, b
        del plain_det
        torch.cuda.empty_cache()

        keep = _replayable(det, samples)
        if not keep or keep[-1] != len(samples) - 1:
            fail(f"the ring of {name} holds no sample to replay the head on")
        rsamples = [samples[i] for i in keep]
        rpreds = [preds[i] for i in keep]
        calls.clear()
        with torch.inference_mode(), plain_versions():
            replayed = replay_head(torch, dev, model, det, det.ring, rsamples)
        worst, exact = _output_gap(torch, rpreds, replayed)
        log(f"streaming [{name}]: the head with the plain versions over the "
            f"kernel run's ring: worst {worst:.3g} of the tolerance; "
            f"bit-equal: {exact}")
        if not worst <= 1.0:
            fail(f"the head with the plain versions differs from the kernel "
                 f"run ({name})")

        calls.clear()
        with torch.inference_mode():
            again = replay_head(torch, dev, model, det, det.ring, rsamples)
        kernel_calls, calls = calls, []
        if not _output_gap(torch, rpreds, again)[1]:
            fail(f"the head replayed with the kernels differs from the "
                 f"kernel run ({name})")
        del again

        worst, exact = _output_gap(torch, preds, plain_preds)
        per = len(plain_calls) // len(samples)
        plain_calls = [c for i in keep
                       for c in plain_calls[i * per:(i + 1) * per]]
        masks, first = _flipped_queries(kernel_calls, plain_calls,
                                        len(rsamples))
        agree, flip = _agreeing_gap(rpreds, [plain_preds[i] for i in keep],
                                    masks)
        del plain_calls
        for key in ("all_cls_scores", "all_bbox_preds"):
            d_last = (preds[-1][key] - plain_preds[-1][key]).abs().max()
            log(f"streaming [{name}]: kernel vs plain run, last sample "
                f"{key}: max abs diff {d_last.item():.4g}")
        gen = torch.Generator(device=dev).manual_seed(6)

        def nudge(table):
            bits = _int_view(torch, table)
            move = torch.rand(table.shape, generator=gen,
                              device=dev) < NUDGE_SHARE
            # one ulp away from zero; an e4m3 entry one ulp toward zero (its
            # top code is NaN), which for a nonzero entry keeps its sign
            fp8 = table.element_size() == 1
            live = (bits & 0x7F) != 0 if fp8 else table != 0
            return torch.where(move & live, bits + (-1 if fp8 else 1),
                               bits).view(table.dtype)

        nudged = [tuple(map(nudge, level)) if isinstance(level, tuple)
                  else nudge(level) for level in det.ring]
        with torch.inference_mode():
            probe = replay_head(torch, dev, model, det, tuple(nudged),
                                samples[-1:])
        layers = len(kernel_calls) // len(samples)
        p_masks, p_first = _flipped_queries(kernel_calls[-layers:], calls,
                                            1)
    finally:
        projection.project_points_qmajor = project
    amp, _ = _output_gap(torch, preds[-1:], probe)
    p_agree, p_flip = _agreeing_gap(preds[-1:], probe, p_masks)
    del nudged, kernel_calls, calls
    torch.cuda.empty_cache()
    q = masks[0].numel()
    if len(keep) < len(samples):
        log(f"streaming [{name}]: the head replays ran over samples {keep} "
            f"(the ring of {det.cache_size} slots no longer holds every "
            "frame of the others)")
    log(f"streaming [{name}]: kernel vs plain run over all samples: worst "
        f"{worst:.3g} of the tolerance ({STREAM_TOL:g} of the output scale); "
        f"bit-equal: {exact}; ring bit-equal: {ring_exact}. Probe: "
        f"{NUDGE_SHARE:g} of the ring's entries one ulp off move the last "
        f"sample's outputs by {amp:.3g} of the tolerance")
    log(f"streaming [{name}]: view choices, kernel vs plain run: queries "
        f"whose choice differs in some layer, per sample "
        f"{[int(m.sum().item()) for m in masks]} of {q} (first difference "
        f"by layer {first}); worst over the queries that agree {agree:.3g} "
        f"of the tolerance, over those that differ {flip:.3g}. Probe: "
        f"{int(p_masks[0].sum().item())} of {q} queries differ (by layer "
        f"{p_first}); worst over the rest {p_agree:.3g}, over those "
        f"{p_flip:.3g}")
    if path.get("exact", True):
        if not worst <= 1.0:
            fail(f"kernel run differs from the plain run ({name}): worst "
                 f"{worst:.3g} of the tolerance")
    elif not ring_exact:
        log(f"streaming [{name}]: end to end not held to the tolerance: the "
            "rings differ in rounding (the attention kernel sums in another "
            "order), the seeded head moves most queries' view choices on "
            "that, and the queries whose choices agree differ about as far")


# ------------------------------------------------------------- phase 5 --

# hybrid vs "xla" path on the same inputs: the one-hot levels take bf16
# tables (for fp32 features, a rounding of every tap), bf16 y and x weights
# and round each column's weighted taps to bf16 (JAX msmv_pallas.py
# :119-125, :81), where the y-fold path keeps fp32 (bf16 features: bf16
# x weights only); with a bf16 accumulator each level's sum rounds too. A
# few bf16 roundings of values up to the output scale, hence 2^-5 of it.
HYBRID_VS_XLA_TOL = 2.0 ** -5
# tap fold vs the sampling op on the same points: the epilogue takes the x
# weights in fp32 and sums the levels in fp32 with one rounding at the end;
# the bf16 op rounds the x weights to bf16 and each level's sum into a bf16
# accumulator: again a few bf16 roundings (2^-5 of the output scale). In
# fp32 only the order of the fp32 sums differs (1e-5 of the scale).
TAP_FOLD_VS_SAMPLING_TOL = {"bfloat16": 2.0 ** -5, "float32": 1e-5}


def _slice_feats(fpn, groups):
    """Per-level FPN maps ``[T, N, H, W, G*Cg]`` -> ``[G*T, N, H, W, Cg]``:
    slice ``g*T + t`` is group g of frame t, the slice order of the
    decoder's locations (``project_points_qmajor``)."""
    out = []
    for f in fpn:
        t, n, h, w, c = f.shape
        out.append(f.reshape(t, n, h, w, groups, c // groups)
                   .permute(4, 0, 1, 2, 3, 5)
                   .reshape(groups * t, n, h, w, c // groups).contiguous())
    return out


def _hybrid_sampling_per_level(packed, loc, sw):
    """The hybrid sampling call with the one-hot levels taken one at a time,
    as the path ran before the fused kernel: per level the point arguments,
    the casts and the add as eager PyTorch ops around one launch of the
    per-level kernel. Same bits as the path; the yardstick for the fused
    kernel's time and launch count."""
    from sparsebev_tpu_torch.ops import msmv_onehot as oh
    from sparsebev_tpu_torch.ops import msmv_sampling as ms
    s, q, p, _ = loc.shape
    k, c = s * q * p, packed.channels
    n_yf = sum(1 for t in packed.tables if t is not None)
    prefix = ms.PackedFeatures(packed.tables[:n_yf], s, packed.num_views,
                               packed.level_shapes[:n_yf], c)
    out = ms.msmv_sampling(prefix, loc.transpose(0, 1).contiguous(),
                           sw[..., :n_yf].transpose(0, 1).contiguous())
    out = out.transpose(0, 1).reshape(k, c)
    x, y = loc[..., 0].reshape(k), loc[..., 1].reshape(k)
    view = oh._view_index(loc[..., 2].reshape(k), packed.num_views)
    for lvl in range(n_yf, len(packed.level_shapes)):
        h, w = packed.level_shapes[lvl]
        args = oh._onehot_level_weights(
            x, y, view, sw[..., lvl].reshape(k).float(), h, w)
        res = oh.onehot_sample_level(
            packed.mxu_tables[lvl],
            *[a.reshape(s, q * p).contiguous() for a in args], w=w, c=c)
        out = out + res.reshape(k, c).to(out.dtype)
    return out.reshape(s, q, p, c)


def hybrid_phase(torch, flush, bw, cap):
    """The hybrid path at r50 full width: ``set_sampling_impl("hybrid")``,
    ``pack_mlvl_feats`` and slice-major ``msmv_sampling`` on the recorded
    FPN maps (split into G groups) and one decoder layer's points, with bf16
    and fp32 features. Returns the launch counts of the path's runs and of
    the per-level kernel's own run, and the numbers of the fused and the
    per-level one-hot kernels."""
    from sparsebev_tpu_torch.ops import msmv_onehot, msmv_pack
    from sparsebev_tpu_torch.ops import msmv_sampling as ms
    _, loc_q, sw_q = cap["sampling"]
    loc = loc_q.transpose(0, 1).contiguous()           # [S, Q, P, 3]
    sw = sw_q.transpose(0, 1).contiguous()             # [S, Q, P, L]
    s, q, p, _ = loc.shape
    t = cap["fpn"][0].shape[0]
    feats = _slice_feats(cap["fpn"], s // t)
    counters = dict(pack=msmv_pack.pack_level, sampling=ms.msmv_sampling,
                    onehot_fused=msmv_onehot.onehot_sample_levels)
    launches = dict.fromkeys(counters, 0)

    def run(fs, impl):
        ms.set_sampling_impl(impl)
        return ms.msmv_sampling(ms.pack_mlvl_feats(fs), loc, sw, qmajor=False)

    try:
        for dtype in (torch.bfloat16, torch.float32):
            fs = [f.to(dtype) for f in feats]
            dname = str(dtype)[6:]
            for c in counters.values():
                c.launches = 0
            got = run(fs, "hybrid")
            torch.cuda.synchronize()
            for k, c in counters.items():
                launches[k] += c.launches
            packed = ms.pack_mlvl_feats(fs)
            mxu = [lvl for lvl, m in enumerate(packed.mxu_tables)
                   if m is not None]
            acc = torch.float32 if packed.tables[0] is None else dtype
            if tuple(got.shape) != (s, q, p, feats[0].shape[-1]) \
                    or got.dtype != acc or mxu != [1, 2, 3]:
                fail(f"hybrid path: output {tuple(got.shape)} {got.dtype}, "
                     f"one-hot levels {mxu}")
            if not bool(torch.isfinite(got).all()):
                fail("hybrid path: non-finite output")
            with plain_versions():
                plain = run(fs, "hybrid")
            xla = run(fs, "xla")
            per_level = _hybrid_sampling_per_level(packed, loc, sw)
            torch.cuda.synchronize()
            if not _bit_equal(torch, got, plain):
                d = (got.float() - plain.float()).abs().max().item()
                fail(f"hybrid path ({dname}) differs from its plain run "
                     f"(max {d:.4g})")
            if not _bit_equal(torch, got, per_level):
                fail(f"hybrid path ({dname}) differs from the same call "
                     "with the one-hot levels taken one at a time")
            d = (got.float() - xla.float()).abs().max().item()
            scale = xla.float().abs().max().item()
            log(f"hybrid [r50] {dname} features: one-hot levels {mxu}, "
                f"y-fold levels {[lvl for lvl in range(len(packed.tables)) if lvl not in mxu]}; "
                f"bit-equal to the plain run and to the per-level route; "
                f"max|hybrid - xla| = {d:.4g} "
                f"(output scale {scale:.4g}, tolerance "
                f"{HYBRID_VS_XLA_TOL * scale:.4g}); mean "
                f"{(got.float() - xla.float()).abs().mean().item():.3g}")
            if not d <= HYBRID_VS_XLA_TOL * scale:
                fail(f"hybrid path ({dname}) is too far from the xla path")
            ms.set_sampling_impl("xla")
            packed_x = ms.pack_mlvl_feats(fs)

            def hybrid_sampling():
                return ms.msmv_sampling(packed, loc, sw, qmajor=False)

            def xla_sampling():
                return ms.msmv_sampling(packed_x, loc, sw, qmajor=False)

            def per_level_sampling():
                return _hybrid_sampling_per_level(packed, loc, sw)

            busy = PLAIN_BUSY_CYCLES      # each of these makes many launches
            times = dict(
                hybrid=time_ms(torch, lambda: run(fs, "hybrid"), 20, flush,
                               busy),
                xla=time_ms(torch, lambda: run(fs, "xla"), 20, flush, busy),
                hybrid_sampling=time_ms(torch, hybrid_sampling, 20, flush,
                                        busy),
                per_level_sampling=time_ms(torch, per_level_sampling, 20,
                                           flush, busy),
                xla_sampling=time_ms(torch, xla_sampling, 20, flush, busy))
            kernels = (ms.msmv_sampling, msmv_onehot.onehot_sample_levels,
                       msmv_onehot.onehot_sample_level)
            traced = dict(
                hybrid=device_ops(torch, hybrid_sampling, kernels),
                per_level=device_ops(torch, per_level_sampling, kernels),
                xla=device_ops(torch, xla_sampling, kernels))
            ops = {k: v[0] for k, v in traced.items()}
            counted = {k: v[1] for k, v in traced.items()}
            log(f"hybrid [r50] {dname} features: pack + sampling "
                f"{times['hybrid']:.4f} ms (xla path {times['xla']:.4f} ms); "
                f"sampling alone {times['hybrid_sampling']:.4f} ms in "
                f"{ops['hybrid']} device ops, {counted['hybrid']} of them "
                f"kernel launches (one-hot levels one at a time, as before "
                f"the fused kernel: {times['per_level_sampling']:.4f} ms in "
                f"{ops['per_level']} ops, {counted['per_level']} launches; "
                f"xla {times['xla_sampling']:.4f} ms in {ops['xla']} ops, "
                f"{counted['xla']} launches)")
            for k, v in ops.items():
                if v is None:
                    log(f"hybrid [r50] {dname}: {k}: device ops not measured, "
                        "five profiler traces in a row held fewer device ops "
                        "than the counted launches")
            if not counted["hybrid"] < counted["per_level"]:
                fail("the fused one-hot kernel saved no kernel launch")
            if None not in (ops["hybrid"], ops["per_level"]) \
                    and not ops["hybrid"] < ops["per_level"]:
                fail("the fused one-hot kernel saved no device launch")
            del got, plain, xla, per_level, packed_x
        onehot_launches, onehot, fused = check_onehot(torch, flush, bw,
                                                      packed, loc, sw)
    finally:
        ms.set_sampling_impl("xla")
    log("hybrid [r50]: kernel launches "
        + " ".join(f"{k}={v}" for k, v in launches.items()))
    for k, v in launches.items():
        if v <= 0:
            fail(f"kernel {k} of the hybrid path was never launched")
    return launches, onehot_launches, onehot, fused


def _touched_bytes(torch, si, args, nh, w, c):
    """Bytes of the table runs (C bf16 values) that these points' taps touch
    with a nonzero weight, each run counted once."""
    rows0, rows1, wy0, wy1, x0, wx0, wx1 = [a.reshape(-1) for a in args]
    keys = []
    for rows, wy in ((rows0, wy0), (rows1, wy1)):
        for dx, wx in ((0, wx0), (1, wx1)):
            live = (wy != 0) & (wx != 0)
            keys.append(((si * nh + rows.long()) * w + x0.long() + dx)[live])
    return torch.unique(torch.cat(keys)).numel() * c * 2


def check_onehot(torch, flush, bw, packed, loc, sw):
    """The two one-hot kernels on the hybrid pack's MXU levels and one
    decoder layer's points, bit for bit against their plain versions, timed.

    Per level: the per-level entry once (counted), then the kernel against
    its plain version. Its bound counts the table runs these points touch
    with a nonzero weight, read once, 28 bytes of per-point arguments and
    the fp32 output. The fused kernel: every level in one launch onto a bf16
    and an fp32 accumulator that holds the y-fold level's result, and onto
    zeros (no prefix). Its bound counts the same table runs, the locations
    and scale weights once, and the accumulator read once and written
    once."""
    from sparsebev_tpu_torch.ops import msmv_onehot as oh
    from sparsebev_tpu_torch.ops import msmv_sampling as ms
    s, q, p, _ = loc.shape
    k, c, n = s * q * p, packed.channels, packed.num_views
    x, y = loc[..., 0].reshape(k), loc[..., 1].reshape(k)
    view = oh._view_index(loc[..., 2].reshape(k), n)
    si = torch.arange(s, device=loc.device).repeat_interleave(q * p)
    mxu = [lvl for lvl, t in enumerate(packed.mxu_tables) if t is not None]
    tables = [packed.mxu_tables[lvl] for lvl in mxu]
    shapes = [packed.level_shapes[lvl] for lvl in mxu]
    level = dict(ms=0.0, plain_ms=0.0, nbytes=0)
    touched_all = 0
    level_args = [[a.reshape(s, q * p).contiguous()
                   for a in oh._onehot_level_weights(
                       x, y, view, sw[..., lvl].reshape(k).float(), h, w)]
                  for lvl, (h, w) in zip(mxu, shapes)]
    oh.onehot_sample_level.launches = 0
    gots = [oh.onehot_sample_level(table, *args, w=w, c=c)
            for table, args, (_, w) in zip(tables, level_args, shapes)]
    torch.cuda.synchronize()
    launches = oh.onehot_sample_level.launches
    for lvl, table, (h, w), args, got in zip(mxu, tables, shapes, level_args,
                                             gots):
        want = oh.onehot_sample_level_plain(table, *args, w=w, c=c)
        torch.cuda.synchronize()
        if not _bit_equal(torch, got, want):
            d = (got - want).abs().max().item()
            fail(f"one-hot kernel differs from its plain version at level "
                 f"{lvl} ({h}x{w}, max {d:.4g})")
        kern = time_ms(torch, lambda: oh.onehot_sample_level(
            table, *args, w=w, c=c), 30, flush)
        plain = time_ms(torch, lambda: oh.onehot_sample_level_plain(
            table, *args, w=w, c=c), 20, flush, PLAIN_BUSY_CYCLES)
        touched = _touched_bytes(torch, si, args, table.shape[1], w, c)
        lvl_bytes = touched + k * (28 + 4 * c)
        log(f"onehot [r50 levels] level {lvl} ({h}x{w}, "
            f"{table.numel() * 2 / 1e6:.1f} MB table): bit-equal to plain; "
            f"{kern:.4f} ms (plain {plain:.4f} ms), bound "
            f"{lvl_bytes / bw * 1e3:.4f} ms ({touched / 1e6:.1f} MB of the "
            f"table touched, {lvl_bytes / 1e6:.1f} MB in all)")
        level["ms"] += kern
        level["plain_ms"] += plain
        level["nbytes"] += lvl_bytes
        touched_all += touched
    del gots, got, want, level_args, args
    if launches != len(mxu):
        fail(f"one-hot per-level kernel: {launches} launches for "
             f"{len(mxu)} levels")
    log(f"onehot [r50 levels]: {len(mxu)} levels {level['ms']:.4f} ms (plain "
        f"{level['plain_ms']:.4f} ms), bound "
        f"{level['nbytes'] / bw * 1e3:.4f} ms ({level['nbytes'] / 1e6:.1f} "
        f"MB): {100 * level['nbytes'] / bw * 1e3 / level['ms']:.1f}% of the "
        f"bound; launches in its run: {launches}")

    # the fused kernel: accumulators that hold the y-fold level's result
    n_yf = mxu[0]
    prefix = ms.PackedFeatures(packed.tables[:n_yf], s, n,
                               packed.level_shapes[:n_yf], c)
    pre = ms.msmv_sampling(prefix, loc.transpose(0, 1).contiguous(),
                           sw[..., :n_yf].transpose(0, 1).contiguous())
    pre = pre.transpose(0, 1).reshape(k, c).float()
    fused = {}
    for acc_dtype in (torch.bfloat16, torch.float32):
        aname = str(acc_dtype)[6:]
        for label, base in (("y-fold prefix", pre.to(acc_dtype)),
                            ("no prefix", torch.zeros_like(
                                pre, dtype=acc_dtype))):
            got = oh.onehot_sample_levels(tables, shapes, mxu, loc, sw,
                                          base.clone(), n, c)
            want = oh.onehot_sample_levels_plain(tables, shapes, mxu, loc, sw,
                                                 base.clone(), n, c)
            torch.cuda.synchronize()
            if not _bit_equal(torch, got, want):
                d = (got.float() - want.float()).abs().max().item()
                fail(f"fused one-hot kernel differs from its plain version "
                     f"({aname} accumulator, {label}, max {d:.4g})")
            del got, want
        base = pre.to(acc_dtype)
        kern = time_ms(torch, lambda: oh.onehot_sample_levels(
            tables, shapes, mxu, loc, sw, base, n, c), 30, flush)
        base = pre.to(acc_dtype)
        plain = time_ms(torch, lambda: oh.onehot_sample_levels_plain(
            tables, shapes, mxu, loc, sw, base, n, c), 20, flush,
            PLAIN_BUSY_CYCLES)
        nbytes = touched_all + loc.numel() * 4 \
            + sw.numel() * sw.element_size() + 2 * k * c * base.element_size()
        bound_ms = nbytes / bw * 1e3
        log(f"onehot_fused [hybrid] {aname} accumulator: bit-equal to plain "
            f"with a y-fold prefix and without; {len(mxu)} levels in one "
            f"launch {kern:.4f} ms (plain {plain:.4f} ms; the per-level "
            f"kernel's {len(mxu)} launches {level['ms']:.4f} ms), bound "
            f"{bound_ms:.4f} ms ({touched_all / 1e6:.1f} MB of the tables "
            f"touched, {nbytes / 1e6:.1f} MB in all): "
            f"{nbytes / kern / 1e6:.0f} GB/s, {100 * bound_ms / kern:.1f}% "
            "of the bound")
        if acc_dtype == torch.bfloat16:
            fused = dict(max_abs_err=0.0, ms=kern, plain_ms=plain,
                         bound_ms=bound_ms, bound_by="bytes",
                         library_ms=None, per_level_ms=level["ms"])
        else:
            fused.update(fp32_acc_ms=kern, fp32_acc_bound_ms=bound_ms)
    return ({"onehot": launches},
            dict(max_abs_err=0.0, ms=level["ms"], plain_ms=level["plain_ms"],
                 bound_ms=level["nbytes"] / bw * 1e3, bound_by="bytes",
                 library_ms=None), fused)


def _gather_windows(torch, packed, loc, sw):
    """The y-fold windows ``[K, 2, 2C]`` of every level at these query-major
    points and their weights ``[K, 4]`` = (wxa, wxb, wya*lw, wyb*lw)."""
    from sparsebev_tpu_torch.ops import msmv_sampling as ms
    q, s, p, _ = loc.shape
    k, c = q * s * p, packed.channels
    x, y = loc[..., 0].reshape(k), loc[..., 1].reshape(k)
    view = ms._view_index(loc[..., 2].reshape(k), packed.num_views)
    batch_row = packed.slice_map.to(torch.int64).repeat_interleave(p) \
        .repeat(q)
    lw = sw.reshape(k, -1)
    gathered, weights = [], []
    for lvl, (h, w) in enumerate(packed.level_shapes):
        sx, ry, (wxa, wxb), (wya, wyb) = ms._separable_slot_weights(
            x * (w - 1), y * (h - 1), h, w)
        flat = packed.tables[lvl].reshape(-1, 2 * c)
        col = packed.row_index(batch_row, view, ry, h) * (w + 1) + sx
        gathered.append(torch.stack([flat[col], flat[col + 1]], 1))
        weights.append(torch.stack([wxa, wxb, wya * lw[:, lvl],
                                    wyb * lw[:, lvl]], 1).contiguous())
    return gathered, weights


def check_tap_fold(torch, flush, bw, fp32_rate, cap):
    """``tap_fold_epilogue`` on the windows of the r50 ring at one decoder
    layer's points (K = Q*T*G*P, L = 4): its entry point once (counted),
    bf16 and fp32 windows bit for bit against the plain version, and
    within a stated tolerance of the sampling op on the same points."""
    from sparsebev_tpu_torch.ops import msmv_sampling as ms
    from sparsebev_tpu_torch.ops.msmv_epilogue import (
        tap_fold_epilogue, tap_fold_epilogue_plain)
    packed, loc, sw = cap["sampling"]
    if not all(packed.yfold):
        fail("tap fold: the r50 ring should hold y-fold levels only")
    c = packed.channels
    gathered, weights = _gather_windows(torch, packed, loc, sw)
    k = weights[0].shape[0]
    tap_fold_epilogue.launches = 0
    first = tap_fold_epilogue(gathered, weights, c, torch.bfloat16)
    torch.cuda.synchronize()
    launches = tap_fold_epilogue.launches
    if launches <= 0 or not bool(torch.isfinite(first).all()):
        fail("tap fold: the kernel was not launched or gave non-finite values")
    fp32_packed = ms.PackedFeatures(
        [t.float() for t in packed.tables], packed.batch, packed.num_views,
        packed.level_shapes, c, num_groups=packed.num_groups,
        slice_map=packed.slice_map, yfold=packed.yfold)
    err = 0.0
    for dtype, pk in ((torch.bfloat16, packed), (torch.float32, fp32_packed)):
        dname = str(dtype)[6:]
        gs = [g.to(dtype) for g in gathered]
        got = tap_fold_epilogue(gs, weights, c, dtype)
        want = tap_fold_epilogue_plain(gs, weights, c, dtype)
        ref = ms.msmv_sampling(pk, loc, sw).reshape(k, c)
        torch.cuda.synchronize()
        if not _bit_equal(torch, got, want):
            fail(f"tap fold kernel ({dname}) differs from its plain version")
        d = (got.float() - ref.float()).abs().max().item()
        scale = ref.float().abs().max().item()
        tol = TAP_FOLD_VS_SAMPLING_TOL[dname] * scale
        log(f"tap_fold [r50] {dname} windows: bit-equal to plain; "
            f"max|fold - sampling op| = {d:.4g} (output scale {scale:.4g}, "
            f"tolerance {tol:.4g})")
        if not d <= tol:
            fail(f"tap fold ({dname}) is too far from the sampling op")
        err = max(err, d)
        del gs, got, want, ref
    ms_k = time_ms(torch, lambda: tap_fold_epilogue(
        gathered, weights, c, torch.bfloat16), 30, flush)
    plain_ms = time_ms(torch, lambda: tap_fold_epilogue_plain(
        gathered, weights, c, torch.bfloat16), 20, flush, PLAIN_BUSY_CYCLES)
    nbytes = sum(g.numel() * 2 + w.numel() * 4
                 for g, w in zip(gathered, weights)) + k * c * 2
    flops = k * len(gathered) * 10 * c + k * c
    bound_ms = max(nbytes / bw, flops / fp32_rate) * 1e3
    bound_by = "bytes" if nbytes / bw >= flops / fp32_rate else "operations"
    log(f"tap_fold [r50] bf16: K={k}, {len(gathered)} levels: {ms_k:.4f} ms "
        f"(plain {plain_ms:.4f} ms), bound {bound_ms:.4f} ms by {bound_by} "
        f"({nbytes / 1e6:.1f} MB); launches in its run: {launches}")
    return {"tap_fold": launches}, dict(
        max_abs_err=err, ms=ms_k, plain_ms=plain_ms, bound_ms=bound_ms,
        bound_by=bound_by, library_ms=None)


def mixing_routes(torch, p):
    """The mixing core's tensor-core route for each dtype at ``p``
    in-points (C = 64, O = 128): its kernel, threads and dynamic shared
    memory a block, blocks an SM, and what ptxas reported for its two
    instantiations (two-pass and one-pass statistics). Printed; returned by
    dtype name."""
    from sparsebev_tpu_torch.kernels import build
    from sparsebev_tpu_torch.ops import mixing
    report = {r["kernel"]: r for r in ptxas_report(
        build.BUILD_LOGS.get("mixing", ""))}
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    pp = mixing.padded_points(p)
    routes = {}
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype)[6:]
        info = mixing.route_info(dtype, p)
        kern = dict(mma="mixing_mma_kernel",
                    tf32="mixing_tf32_kernel")[info["route"]]
        ptx = [report.get(f"{kern}<{pp}, {flag}>")
               for flag in ("true", "false")]
        ptx_msg = "; ".join(
            f"{stats}: {r['regs']} registers, {r['stack']} bytes stack "
            f"frame, spills {r['spill_stores']} / {r['spill_loads']} bytes"
            if r else f"{stats}: no ptxas report (built earlier)"
            for stats, r in zip(("two-pass", "one-pass"), ptx))
        per_sm = info["resident_blocks"] // sms
        log(f"mixing route [P={p}] {dname}: {kern}<{pp}> "
            f"({info['route']}): {info['threads']} threads, "
            f"{info['smem_bytes']} bytes of dynamic shared memory a block, "
            f"{per_sm} block(s) an SM ({info['resident_blocks']} on the "
            f"card); ptxas {ptx_msg}")
        routes[dname] = dict(
            route=info["route"], kernel=f"{kern}<{pp}>",
            threads=info["threads"], smem_bytes=info["smem_bytes"],
            blocks_per_sm=per_sm,
            registers=[r["regs"] if r else None for r in ptx],
            spill_bytes=[r["spill_stores"] + r["spill_loads"] if r else None
                         for r in ptx])
    return routes


def check_mixing(torch, flush, bw, fp32_rate, bf16_rate, name, xms):
    """``mixing_core`` (two-pass) and ``mixing_core_batched`` (one-pass) on
    one ``AdaptiveMixing`` call's operands of the ``name`` stream, as
    recorded (bf16) and in fp32: each entry point once (counted), then
    against the plain version within ``MIXING_TOL``, timed beside the
    decoder's own chain (two ``torch.matmul`` and two ``_ln2d``) and beside
    its bound; in fp32 the bound both ways: three TF32 products on the
    tensor cores (the fp32 route's own work) and one fp32 product on the
    FMA units."""
    from sparsebev_tpu_torch.models.decoder import _ln2d
    from sparsebev_tpu_torch.ops import mixing
    torch.backends.cuda.matmul.allow_tf32 = False
    x, m, s = xms
    n, g, p, c = x.shape
    o = s.shape[2]
    routes = mixing_routes(torch, p)
    entries = dict(mixing=(mixing.mixing_core, "twopass"),
                   mixing_batched=(mixing.mixing_core_batched, "onepass"))
    launches = dict.fromkeys(entries, 0)
    err = dict.fromkeys(entries, 0.0)
    result = {}
    tf32_rate = bf16_rate / 2
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype)[6:]
        route = mixing.mixing_route(dtype, p, c, o)
        xd, md, sd = (t.to(dtype).contiguous() for t in (x, m, s))
        for fn, _ in entries.values():
            fn.launches = 0
        outs = {key: fn(xd, md, sd) for key, (fn, _) in entries.items()}
        torch.cuda.synchronize()
        for key, (fn, _) in entries.items():
            launches[key] += fn.launches
        rtol, atol = mixing.MIXING_TOL[dname]
        for key, (fn, stats) in entries.items():
            got = outs[key]
            want = mixing.mixing_core_plain(xd, md, sd, stats=stats)
            torch.cuda.synchronize()
            if got.dtype != dtype or tuple(got.shape) != (n, g, o, c) \
                    or not bool(torch.isfinite(got).all()):
                fail(f"{key} [{name}]: output {tuple(got.shape)} {got.dtype}")
            diff = (got.float() - want.float()).abs()
            scale = max(1.0, want.float().abs().max().item())
            bad = diff > rtol * want.float().abs() + atol * scale
            log(f"{key} [{name}] {dname} ({route}): max|kernel - plain| = "
                f"{diff.max().item():.4g} (output scale {scale:.4g}), "
                f"{int((diff > 0).sum())} of {diff.numel()} differ, "
                f"{int(bad.sum())} beyond the tolerance")
            if bool(bad.any()):
                fail(f"{key} kernel [{name}, {dname}] differs from its plain "
                     "version beyond the tolerance")
            err[key] = max(err[key], diff.max().item())

        def chain():
            h = torch.matmul(xd, md)
            h = torch.relu(_ln2d(h)).to(dtype)
            return torch.relu(_ln2d(torch.matmul(sd, h))).to(dtype)

        items = n * g
        nbytes = (xd.numel() + md.numel() + sd.numel() + items * o * c) \
            * xd.element_size()
        flops = 2 * items * (p * c * c + o * p * c)
        if dtype == torch.bfloat16:
            bound_ms = max(nbytes / bw, flops / bf16_rate) * 1e3
            bound_by = "bytes" if nbytes / bw >= flops / bf16_rate \
                else "operations"
            both = ""
        else:
            tc_ms = max(nbytes / bw, 3 * flops / tf32_rate) * 1e3
            tc_by = "bytes" if nbytes / bw >= 3 * flops / tf32_rate \
                else "operations"
            fma_ms = max(nbytes / bw, flops / fp32_rate) * 1e3
            fma_by = "bytes" if nbytes / bw >= flops / fp32_rate \
                else "operations"
            bound_ms, bound_by = ((tc_ms, tc_by) if route == "tf32"
                                  else (fma_ms, fma_by))
            both = (f"; the fp32 bound both ways: 3xTF32 {tc_ms:.4f} ms by "
                    f"{tc_by} (3 x {flops / 1e9:.2f} GFLOP at "
                    f"{tf32_rate / 1e12:.1f} TFLOP/s), one product on the "
                    f"FMA units {fma_ms:.4f} ms by {fma_by} "
                    f"({fp32_rate / 1e12:.0f} TFLOP/s)")
        chain_ms = time_ms(torch, chain, 20, flush, PLAIN_BUSY_CYCLES)
        for key, (fn, stats) in entries.items():
            kern = time_ms(torch, lambda: fn(xd, md, sd), 30, flush)
            plain = time_ms(torch, lambda: mixing.mixing_core_plain(
                xd, md, sd, stats=stats), 20, flush, PLAIN_BUSY_CYCLES)
            rate_gbs = nbytes / kern / 1e6
            share = bound_ms / kern
            log(f"{key} [{name}] {dname} ({route} kernel): {items} "
                f"items (BQ={n}, G={g}, P={p}, C={c}, O={o}) "
                f"{kern:.4f} ms (plain {plain:.4f} ms; the decoder's chain "
                f"{chain_ms:.4f} ms), bound {bound_ms:.4f} ms by {bound_by} "
                f"({nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP): "
                f"{rate_gbs:.0f} GB/s achieved, {100 * share:.1f}% of the "
                f"bound{both}")
            if dtype == torch.bfloat16:
                result[key] = dict(ms=kern, plain_ms=plain, bound_ms=bound_ms,
                                   bound_by=bound_by, library_ms=None,
                                   chain_ms=chain_ms, gbytes_per_s=rate_gbs,
                                   bound_share=share, route=route,
                                   route_info=routes)
            else:
                result[key].update(
                    fp32_ms=kern, fp32_plain_ms=plain,
                    fp32_chain_ms=chain_ms, fp32_route=route,
                    fp32_bound_ms=bound_ms, fp32_bound_by=bound_by,
                    fp32_tf32_bound_ms=tc_ms, fp32_fma_bound_ms=fma_ms,
                    fp32_gbytes_per_s=rate_gbs, fp32_bound_share=share)
        del xd, md, sd, outs
    for key, v in launches.items():
        if v <= 0:
            fail(f"kernel {key} was never launched in its run [{name}]")
        result[key]["max_abs_err"] = err[key]
    return launches, result


# the mixing core's shapes in the configs: (path, BQ, P) with G = 4,
# C = 64, O = 128
MIXING_SHAPES = (("r50", 900, 32), ("vov99", 1600, 60), ("eva02", 1600, 120))


def mixing_operands(torch, dev, bq, p, c=64, seed=4):
    """Seeded bf16 operands of the mixing core at ``(bq, p, c)``: x from
    N(0, 1), m at 1/sqrt(c) and s at 1/sqrt(p) of that, as the recorded
    ones scale."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((bq, 4, p, c), generator=gen, device=dev)
    m = torch.randn((bq, 4, c, c), generator=gen, device=dev) / math.sqrt(c)
    s = torch.randn((bq, 4, 128, p), generator=gen, device=dev) / math.sqrt(p)
    return [t.to(torch.bfloat16).contiguous() for t in (x, m, s)]


# shapes no config gives the mixing core, one for each route and row copy
# the configs' shapes leave out: (dtype, P, C, the route); O = 128. The
# configs' P (32, 60, 120) give rows of s of 16 bytes in fp32 and of 16
# and 8 bytes in bf16.
MIXING_OTHER_SHAPES = (
    ("bfloat16", 30, 64, "mma"),    # 60-byte rows of s: 4-byte copies
    ("float32", 30, 64, "tf32"),    # 120-byte rows: 8-byte copies
    ("float32", 7, 64, "tf32"),     # 28-byte rows: 4-byte copies
    ("bfloat16", 7, 64, "fma"),     # odd P in bf16
    ("float32", 130, 64, "fma"),    # more in-points than the widest kernel
    ("float32", 32, 32, "fma"),     # another group width
)


def check_mixing_shapes(torch, dev, bq=64):
    """Both mixing entry points at ``MIXING_OTHER_SHAPES`` on seeded
    operands (``bq`` queries, four groups): each shape on the route it
    names, within ``MIXING_TOL`` of the plain version; each route's
    launches held above 0. Untimed. Returns the entries' launches, and per
    entry its largest difference and the launches by route."""
    from sparsebev_tpu_torch.ops import mixing
    entries = dict(mixing=(mixing.mixing_core, "twopass"),
                   mixing_batched=(mixing.mixing_core_batched, "onepass"))
    for fn, _ in entries.values():
        fn.launches = 0
    for route in mixing.route_launches:
        mixing.route_launches[route] = 0
    err = dict.fromkeys(entries, 0.0)
    for dname, p, c, want_route in MIXING_OTHER_SHAPES:
        dtype = getattr(torch, dname)
        route = mixing.mixing_route(dtype, p, c, 128)
        if route != want_route:
            fail(f"mixing [{dname} P={p} C={c}]: route {route}, not "
                 f"{want_route}")
        xd, md, sd = (t.to(dtype).contiguous()
                      for t in mixing_operands(torch, dev, bq, p, c))
        rtol, atol = mixing.MIXING_TOL[dname]
        for key, (fn, stats) in entries.items():
            got = fn(xd, md, sd).float()
            want = mixing.mixing_core_plain(xd, md, sd, stats=stats).float()
            diff = (got - want).abs()
            scale = max(1.0, want.abs().max().item())
            bad = int((diff > rtol * want.abs() + atol * scale).sum())
            log(f"{key} [{dname} P={p} C={c}] ({route}): max|kernel - "
                f"plain| = {diff.max().item():.4g} (output scale "
                f"{scale:.4g}), {bad} beyond the tolerance")
            if bad or not bool(torch.isfinite(got).all()):
                fail(f"{key} kernel [{dname} P={p} C={c}, {route}] differs "
                     "from its plain version beyond the tolerance")
            err[key] = max(err[key], diff.max().item())
        del xd, md, sd
    launches = {key: fn.launches for key, (fn, _) in entries.items()}
    log(f"mixing other shapes: launches {launches}, by route "
        f"{mixing.route_launches}")
    for route, v in mixing.route_launches.items():
        if v <= 0:
            fail(f"the mixing core's {route} route was never launched at "
                 "the other shapes")
    return launches, {key: dict(max_abs_err=err[key],
                                route_launches=dict(mixing.route_launches))
                      for key in entries}


def other_library(other, source):
    """``sparsebev_tpu_torch/csrc/<source>.cu`` of the checkout at
    ``other`` (another commit unpacked with ``git archive`` into a
    gitignored directory), built with this checkout's flags into
    ``BUILD_DIR/lib<source>_other.so`` and loaded."""
    import ctypes
    from sparsebev_tpu_torch.kernels import build
    src = os.path.join(os.path.abspath(other),
                       f"sparsebev_tpu_torch/csrc/{source}.cu")
    lib_path = os.path.join(build.BUILD_DIR, f"lib{source}_other.so")
    os.makedirs(build.BUILD_DIR, exist_ok=True)
    out = subprocess.run([build.find_nvcc(), *build.NVCC_FLAGS, "-o",
                          lib_path, src], capture_output=True, text=True,
                         timeout=600)
    if out.returncode != 0:
        fail(f"nvcc failed for {src}:\n{out.stdout}{out.stderr}")
    return ctypes.CDLL(lib_path)


def mixing_ab(other, reps=30):
    """The mixing core of this checkout against the one of the checkout at
    ``other`` (``git archive`` of another commit in a gitignored directory)
    on one card, on seeded operands at ``MIXING_SHAPES`` in bf16 and fp32,
    both entry points, each library on the route it takes for those
    operands: where both take the same kernel the outputs must be
    bit-equal, else both are held to the plain version within
    ``MIXING_TOL``; then timed in turns (other, this, this, other; CUDA
    events, L2 flushed, median of ``reps`` calls each) (``python3 -c
    "import chip_smoke; chip_smoke.mixing_ab('outputs/parent')"``)."""
    import torch
    sys.path.insert(0, HERE)
    from sparsebev_tpu_torch.kernels import build
    from sparsebev_tpu_torch.ops import mixing
    dev = torch.device("cuda", 0)
    log(f"mixing_ab [{other}]: {nvidia_smi_line()}")
    libs = dict(other=other_library(other, "mixing"), this=mixing._lib())
    for name in ("mixing_core_twopass", "mixing_core_onepass"):
        fn = getattr(libs["other"], name)
        fn.argtypes = getattr(libs["this"], name).argtypes
        fn.restype = getattr(libs["this"], name).restype

    def padded(label, dtype, p):
        # this checkout's tensor-core width where the library takes it for
        # these operands (asked with no items, which launches nothing),
        # else 0, the FMA kernel
        route = mixing.mixing_route(dtype, p, 64, 128)
        if route == "fma":
            return 0
        pp = mixing.padded_points(p)
        rc = libs[label].mixing_core_twopass(
            None, None, None, None, 0, p, 64, 128,
            int(dtype == torch.bfloat16), pp, mixing.EPS, None)
        return pp if rc == 0 else 0

    def call(label, two_pass, x, m, s):
        bq, g, p, c = x.shape
        res = torch.empty((bq, g, 128, c), dtype=x.dtype, device=dev)
        lib = libs[label]
        fn = lib.mixing_core_twopass if two_pass else lib.mixing_core_onepass
        rc = fn(x.data_ptr(), m.data_ptr(), s.data_ptr(), res.data_ptr(),
                bq * g, p, c, 128, int(x.dtype == torch.bfloat16),
                padded(label, x.dtype, p), mixing.EPS,
                torch.cuda.current_stream(dev).cuda_stream)
        build.check(lib, "mixing", rc)
        return res

    flush = torch.empty(64 * 2**20, dtype=torch.int32, device=dev)
    for pname, bq, p in MIXING_SHAPES:
        operands = mixing_operands(torch, dev, bq, p)
        for dtype in (torch.bfloat16, torch.float32):
            dname = str(dtype)[6:]
            xd, md, sd = (t.to(dtype).contiguous() for t in operands)
            rtol, atol = mixing.MIXING_TOL[dname]
            for two_pass in (True, False):
                stats = "twopass" if two_pass else "onepass"
                routes = {label: (f"tensor cores at {pp}" if pp else
                                  "fma")
                          for label in ("other", "this")
                          for pp in [padded(label, dtype, p)]}
                outs = {label: call(label, two_pass, xd, md, sd)
                        for label in ("other", "this")}
                torch.cuda.synchronize()
                if routes["other"] == routes["this"]:
                    held = _bit_equal(torch, outs["this"], outs["other"])
                    what = f"outputs bit-equal {held}"
                else:
                    want = mixing.mixing_core_plain(xd, md, sd, stats=stats)
                    scale = max(1.0, want.float().abs().max().item())
                    gaps = {label: (o.float() - want.float()).abs()
                            for label, o in outs.items()}
                    held = all(not bool((d > rtol * want.float().abs()
                                         + atol * scale).any())
                               for d in gaps.values())
                    what = ("max|kernel - plain| " + ", ".join(
                        f"{label} {d.max().item():.4g}"
                        for label, d in gaps.items())
                        + f" (output scale {scale:.4g}), within the "
                        f"tolerance {held}")
                runs = []
                for label in ("other", "this", "this", "other"):
                    runs.append((label, time_ms(
                        torch, lambda: call(label, two_pass, xd, md, sd),
                        reps, flush)))
                log(f"mixing_ab [{pname} P={p} {dname} {stats}]: routes "
                    f"other {routes['other']}, this {routes['this']}; "
                    f"{what}; ms: "
                    + ", ".join(f"{label} {t:.4f}" for label, t in runs))
                if not held:
                    fail(f"mixing_ab [{pname} {dname} {stats}]: outputs "
                         "differ")
            del xd, md, sd
        del operands
        torch.cuda.empty_cache()


def bringup_slice17(other=None):
    """The mixing core's redesign alone: build ``mixing.cu``, print what
    ptxas reports per kernel, then each shape of ``MIXING_SHAPES`` on
    seeded operands through :func:`check_mixing` (both entry points in
    bf16 and fp32 against the plain version, the routes' blocks and
    registers, timed beside the bounds), and :func:`check_mixing_shapes`;
    with ``other``, :func:`mixing_ab`
    against that checkout (``python3 -c "import chip_smoke;
    chip_smoke.bringup_slice17('outputs/parent')"``)."""
    import torch
    sys.path.insert(0, HERE)
    from sparsebev_tpu_torch.kernels import build
    dev = torch.device("cuda", 0)
    log(nvidia_smi_line())
    t0 = time.perf_counter()
    logs = build.build_all(["mixing"])
    log(f"build: mixing.cu in {time.perf_counter() - t0:.1f} s")
    for r in ptxas_report(logs["mixing"]):
        log(f"ptxas[mixing]: {r['kernel']}: {r['regs']} registers, "
            f"{r['stack']} bytes stack frame, spills {r['spill_stores']} / "
            f"{r['spill_loads']} bytes")
    bw, fp32_rate, bf16_rate = peaks(torch.cuda.get_device_name(0))
    flush = torch.empty(64 * 2**20, dtype=torch.int32, device=dev)
    with torch.inference_mode():
        for pname, bq, p in MIXING_SHAPES:
            check_mixing(torch, flush, bw, fp32_rate, bf16_rate,
                         f"{pname} seeded", mixing_operands(torch, dev, bq,
                                                            p))
            torch.cuda.empty_cache()
        check_mixing_shapes(torch, dev)
    del flush
    if other is not None:
        mixing_ab(other)


# ------------------------------------------------------------- phase 6 --

# sampling backward kernel vs plain, d loc and d sw: fp32 sums of up to
# 4 * C products per level in another order, scaled by up to (W - 1): 1e-4 of
# each gradient's scale. Table gradient: both sides compute the same fp32
# contributions (JAX's order of products) and add them in another order.
# fp32 tables: 1e-5 of the entry plus 1e-5 of the scale. bf16 tables: every
# add is rounded to bf16 on both sides (the kernel's vector reductions; the
# plain version's index backward, which on the card adds one use's
# contributions in fp32 and rounds once, and autograd's bf16 add of the
# uses). An entry with at most two contributions gets the same bits (one
# correctly rounded add, whatever the order). An entry with n contributions
# differs by at most the n - 1 roundings of each side, each at most bf16's
# unit roundoff 2^-8 times the entry's absolute sum A (the sum of
# |contribution|, which bounds every partial sum): 2 * n * 2^-8 * A. That
# bound reaches A itself at n = 128, where it could no longer tell a lost
# add, so the factor is capped at 32: in sound runs on an H100 the largest
# difference read 8.32 x 2^-8 * A, at up to 1,418 contributions an entry.
SAMPLING_BWD_TOL = dict(point=1e-4, table=(1e-5, 1e-5), bf16_round=2.0 ** -8,
                        bf16_cap=32.0)
TRAIN_LEVELS = [(64, 176), (32, 88), (16, 44), (8, 22)]


def synthetic_train_sampling(torch, dev, dtype, q=1540, t=8, seed=5):
    """One decoder layer's sampling operands at r50 training shapes (900
    queries + 640 denoising queries, T = 8 frames of 6 views, G = 4, P = 4,
    C = 64 per group) on seeded random tables, uniform points and an output
    gradient of the table dtype."""
    from sparsebev_tpu_torch.ops.msmv_sampling import PackedFeatures
    gen = torch.Generator(device=dev).manual_seed(seed)
    n, g, cg, p = 6, 4, 64, 4
    s = t * g
    tables = [torch.randn((t * n * h * g, w + 1, 2 * cg), generator=gen,
                          device=dev, dtype=dtype) for h, w in TRAIN_LEVELS]
    loc = torch.stack([
        torch.rand((q, s, p), generator=gen, device=dev) * 1.04 - 0.02,
        torch.rand((q, s, p), generator=gen, device=dev) * 1.04 - 0.02,
        torch.randint(0, n, (q, s, p), generator=gen, device=dev) / (n - 1),
    ], -1).contiguous()
    sw = torch.softmax(torch.randn((q, s, p, len(TRAIN_LEVELS)),
                                   generator=gen, device=dev), -1).contiguous()
    gout = torch.randn((q, s, p, cg), generator=gen, device=dev).to(dtype)
    # the decoder's (g, t) slice order over the (t, g)-ordered tables
    slice_map = (torch.arange(t, device=dev)[None, :] * g
                 + torch.arange(g, device=dev)[:, None]).reshape(s)
    packed = PackedFeatures(tables, s, n, TRAIN_LEVELS, cg, num_groups=g,
                            slice_map=slice_map,
                            gsplit=(False, True, False, False))
    return packed, loc, sw, gout


def _check_table_grads(torch, packed, loc, sw, gout, got, want, label):
    """The kernel's table gradients against the plain version's within
    ``SAMPLING_BWD_TOL``; returns the largest difference."""
    from sparsebev_tpu_torch.ops import msmv_sampling as ms
    c = packed.channels
    bf16 = packed.tables[0].dtype == torch.bfloat16
    if bf16:
        counts = _piece_counts(torch, packed, loc, sw)
        fp32 = [t.float() for t in packed.tables]
        abs_sum = [torch.zeros_like(t) for t in fp32]
        ms.msmv_sampling_backward_plain(packed.replace(tables=fp32), loc,
                                        sw.abs(), gout.abs().float(), abs_sum)
        del fp32
    worst, units, exact, entries = 0.0, 0.0, 0, 0
    for lvl, (a, b) in enumerate(zip(got, want)):
        if a.dtype != packed.tables[lvl].dtype or a.shape != b.shape:
            fail(f"sampling backward [{label}]: level {lvl} table gradient "
                 f"{a.dtype} {tuple(a.shape)}")
        a32, b32 = a.float().view(-1, c), b.float().view(-1, c)
        d = (a32 - b32).abs()
        scale = b32.abs().max().item()
        worst = max(worst, d.max().item())
        if bf16:
            n = counts[lvl][:, None].float()
            room = SAMPLING_BWD_TOL["bf16_round"] * abs_sum[lvl].view(-1, c)
            bad = ((n <= 2) & (d > 0)) \
                | (d > (2 * n).clamp(max=SAMPLING_BWD_TOL["bf16_cap"]) * room)
            units = max(units, (d / room).nan_to_num(0.0).max().item())
            exact += int((d == 0).sum())
            entries += d.numel()
        else:
            rtol, atol = SAMPLING_BWD_TOL["table"]
            bad = d > rtol * b32.abs() + atol * scale
        if not bool(torch.isfinite(a32).all()) or bool(bad.any()):
            fail(f"sampling backward [{label}] level {lvl} table gradient: "
                 f"{int(bad.sum())} entries beyond the tolerance (max "
                 f"{d.max().item():.4g} at scale {scale:.4g})")
        del a32, b32, d, bad
    if bf16:
        log(f"sampling_bwd [{label}] bf16 table gradient: {exact} of "
            f"{entries} entries bit-equal to plain (all with at most two "
            f"contributions are); largest difference {units:.3g} x 2^-8 of "
            f"the entry's absolute sum (tolerance: twice its contribution "
            f"count, up to {max(int(n.max()) for n in counts)}, times that, "
            f"at most {SAMPLING_BWD_TOL['bf16_cap']:g} times)")
    return worst


def check_sampling_backward(torch, flush, bw, fp32_rate, packed, loc, sw,
                            gout, label, timed=True):
    """The sampling backward kernel on these operands against its plain
    version (autograd of the half-row primal over the tables in their
    dtype) within ``SAMPLING_BWD_TOL``; then its time, adding into a
    gradient in the table dtype, beside its bound, with the zeroing of that
    gradient timed apart."""
    from sparsebev_tpu_torch.ops import msmv_sampling as ms
    dname = str(packed.tables[0].dtype)[6:]
    got, want = ([torch.zeros_like(t) for t in packed.tables]
                 for _ in range(2))
    got = (*ms._msmv_sampling_backward_cuda(packed, loc, sw, gout, got), got)
    want = (*ms.msmv_sampling_backward_plain(packed, loc, sw, gout, want),
            want)
    torch.cuda.synchronize()
    err = {}
    for name, a, b in (("d_loc", got[0], want[0]), ("d_sw", got[1], want[1])):
        d = (a - b).abs().max().item()
        scale = b.abs().max().item()
        err[name] = d
        if not bool(torch.isfinite(a).all()) \
                or not d <= SAMPLING_BWD_TOL["point"] * scale:
            fail(f"sampling backward [{label}] {name}: max|kernel - plain| = "
                 f"{d:.4g} at scale {scale:.4g}")
    if bool(got[0][..., 2].any()):
        fail(f"sampling backward [{label}]: the view got a gradient")
    err["d_tables"] = _check_table_grads(torch, packed, loc, sw, gout,
                                         got[2], want[2], label)
    rtol, atol = SAMPLING_BWD_TOL["table"]
    log(f"sampling_bwd [{label}] {dname}: max|kernel - plain| d_loc "
        f"{err['d_loc']:.3g}, d_sw {err['d_sw']:.3g} (tolerance "
        f"{SAMPLING_BWD_TOL['point']:g} of the scale), table gradient "
        f"{err['d_tables']:.3g}" + (
            "" if dname == "bfloat16" else
            f" (tolerance {rtol:.3g} of the entry + {atol:g} of the scale)"))
    del got, want
    torch.cuda.empty_cache()
    result = dict(max_abs_err=max(err.values()), library_ms=None)
    if not timed:
        return result
    grads = [torch.zeros_like(t) for t in packed.tables]
    kern = time_ms(torch, lambda: ms._msmv_sampling_backward_cuda(
        packed, loc, sw, gout, grads), 20, flush)
    no_tables = time_ms(torch, lambda: ms._msmv_sampling_backward_cuda(
        packed, loc, sw, gout), 20, flush)
    zero_ms = time_ms(torch, lambda: [t.zero_() for t in grads], 10, flush)
    plain_ms = time_ms(torch, lambda: ms.msmv_sampling_backward_plain(
        packed, loc, sw, gout, grads), 3, flush, PLAIN_BUSY_CYCLES)
    del grads
    torch.cuda.empty_cache()
    counts = _piece_counts(torch, packed, loc, sw)
    pieces = sum(int((n > 0).sum()) for n in counts)
    adds = sum(int(n.sum()) for n in counts)
    busiest = max(int(n.max()) for n in counts)
    k, c = loc[..., 0].numel(), packed.channels
    itemsize = packed.tables[0].element_size()
    levels = len(packed.level_shapes)
    # an estimate from the inputs, not a count the kernel takes: one
    # 16-byte reduction per lane and nonzero contribution
    requests = adds * c * itemsize // 16
    # each touched piece read once, and its gradient read and written once,
    # in the table dtype; g, loc / sw and their gradients
    nbytes = 3 * pieces * c * itemsize + k * c * itemsize \
        + 2 * (loc.numel() + sw.numel()) * 4 + packed.slice_map.numel() * 4
    flops = k * levels * c * 16
    bound_ms = max(nbytes / bw, flops / fp32_rate) * 1e3
    bound_by = "bytes" if nbytes / bw >= flops / fp32_rate else "operations"
    grad_mb = sum(t.numel() for t in packed.tables) * itemsize / 1e6
    log(f"sampling_bwd [{label}] {dname}: K={k} points, {levels} levels: "
        f"kernel {kern:.4f} ms ({no_tables:.4f} ms without the table "
        f"gradient; plain {plain_ms:.2f} ms), bound {bound_ms:.4f} ms by "
        f"{bound_by} ({nbytes / 1e6:.1f} MB: {pieces} touched pieces of "
        f"{c} channels); beside the kernel, zeroing the {grad_mb:.0f} MB "
        f"{dname} gradient {zero_ms:.4f} ms (once a step)")
    log(f"sampling_bwd [{label}] {dname}: {adds} contributions into "
        f"{pieces} pieces ({adds / pieces:.2f} a piece, at most {busiest}): "
        f"about {requests / 1e6:.1f}M 16-byte reductions (estimated from "
        f"the inputs), {requests / (kern - no_tables) / 1e6:.1f}G a second "
        "over the time the table gradient adds")
    result.update(ms=kern, plain_ms=plain_ms, bound_ms=bound_ms,
                  bound_by=bound_by, no_table_grad_ms=no_tables,
                  grad_zero_ms=zero_ms)
    return result


def check_reduction_rounding(torch, dev):
    """The sampling backward's reductions round every add as JAX's bf16
    scatter-add does: eight points on one pixel of one view each add the
    same value into one entry of a gradient pre-filled with 256, in whatever
    order their reductions land. Adding 1.0: 256 + 1 is a tie that rounds
    to even, so in bf16 every add leaves 256, where an fp32 sum rounded once
    would give 264; with fp32 tables the entry reads 264. Adding 2.0: every
    sum up to 272 is a bf16 number, so the entry reads 272 in bf16 (a
    reduction that adds nothing would leave 256). Every other entry keeps
    its 256 (zero weights add nothing)."""
    from sparsebev_tpu_torch.ops import msmv_sampling as ms
    h = w = 5                        # pixel = loc * 4: exact in fp32
    n, c, k = 2, 64, 8
    loc = torch.tensor([0.5, 0.25, 0.0], device=dev).repeat(k, 1, 1, 1)
    sw = torch.ones((k, 1, 1, 1), device=dev)
    for dtype, add, want in ((torch.bfloat16, 1.0, 256.0),
                             (torch.bfloat16, 2.0, 272.0),
                             (torch.float32, 1.0, 264.0)):
        table = torch.ones((n * h, w + 1, 2 * c), device=dev, dtype=dtype)
        packed = ms.PackedFeatures([table], 1, n, [(h, w)], c)
        grad = torch.full_like(table, 256.0)
        gout = torch.full((k, 1, 1, c), add, device=dev, dtype=dtype)
        ms._msmv_sampling_backward_cuda(packed, loc, sw, gout, [grad])
        torch.cuda.synchronize()
        entry = grad.view(n, h, w + 1, 2 * c)[0, 1, 2, :c]
        others = int((grad != 256.0).sum()) - int((entry != 256.0).sum())
        if not bool((entry == want).all()) or others:
            fail(f"reduction probe ({dtype}): 256 + 8 x {add} read "
                 f"{entry.float().unique().tolist()} ({others} other "
                 f"entries changed), {want} expected")
    log("reduction probe: 256 + 8 x 1.0 into one entry reads 256 in bf16 "
        "(each add rounded) and 264 in fp32, as JAX's scatter-add gives; "
        "256 + 8 x 2.0 reads 272 in bf16")


def check_pack_bwd(torch, dev, flush, bw, levels=TRAIN_LEVELS, m=48,
                   label="r50 train"):
    """The y-fold pack's adjoint at a training step's shapes (r50 by
    default: T * 6 = 48 images a level, C = 256, G = 4, bf16; fp32 once at
    the smallest level): bit for bit against its plain version, timed
    beside its bound."""
    from sparsebev_tpu_torch.ops.msmv_pack import (pack_level_bwd,
                                                   pack_level_bwd_plain)
    gen = torch.Generator(device=dev).manual_seed(7)
    c, g = 256, 4
    ms = plain_ms = 0.0
    nbytes = 0
    for i, (h, w) in enumerate(levels):
        dt = torch.randn((m, h, g, w + 1, 2 * c // g), generator=gen,
                         device=dev).bfloat16()
        for d in ([dt, dt.float()] if i == len(levels) - 1 else [dt]):
            got = pack_level_bwd(d, g)
            want = pack_level_bwd_plain(d, g)
            torch.cuda.synchronize()
            if not _bit_equal(torch, got, want):
                fail(f"pack adjoint differs from its plain version at "
                     f"{h}x{w} ({d.dtype})")
        ms += time_ms(torch, lambda: pack_level_bwd(dt, g), 20, flush)
        plain_ms += time_ms(torch, lambda: pack_level_bwd_plain(dt, g), 10,
                            flush, PLAIN_BUSY_CYCLES)
        nbytes += (m * h * g * w * 2 * (c // g) + got.numel()) * 2
        del dt, got, want
    bound_ms = nbytes / bw * 1e3
    log(f"pack_bwd [{label}]: bit-equal to plain at all {len(levels)} "
        f"levels (bf16; fp32 at the last); {m} images a level {ms:.4f} ms "
        f"(plain {plain_ms:.4f} ms), bound {bound_ms:.4f} ms "
        f"({nbytes / 1e6:.1f} MB moved)")
    return dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by="bytes", library_ms=None)


def check_pack_pair_bwd(torch, dev, flush, bw, shape=(6, 160, 400),
                        label="vov99 L0"):
    """The pair pack's adjoint at the vov99 level-0 shape (bf16; one frame
    by default, the training step's T * 6 = 90 images with ``shape=(90,
    160, 400)``): bit for bit against its plain version and against the one
    PyTorch call that computes it (a slice, a permute and a copy), timed
    beside its bound."""
    from sparsebev_tpu_torch.ops.msmv_pack import (pack_level_pair_bwd,
                                                   pack_level_pair_bwd_plain)
    gen = torch.Generator(device=dev).manual_seed(8)
    (m, h, w), c, g = shape, 256, 4
    dt = torch.randn((m, h, g, w + 1, c // g), generator=gen,
                     device=dev).bfloat16()
    pack_level_pair_bwd.launches = 0
    got = pack_level_pair_bwd(dt, g)
    launches = pack_level_pair_bwd.launches
    want = pack_level_pair_bwd_plain(dt, g)

    def library():
        return dt[:, :, :, :w].permute(0, 1, 3, 2, 4).contiguous()

    torch.cuda.synchronize()
    if launches != 1 or not _bit_equal(torch, got, want) \
            or not _bit_equal(torch, got, library().reshape(m, h, w, c)):
        fail("pair pack adjoint differs from its plain version or the "
             "permute-copy call")
    ms = time_ms(torch, lambda: pack_level_pair_bwd(dt, g), 20, flush)
    plain_ms = time_ms(torch, lambda: pack_level_pair_bwd_plain(dt, g), 10,
                       flush)
    library_ms = time_ms(torch, library, 10, flush)
    nbytes = 2 * got.numel() * 2
    bound_ms = nbytes / bw * 1e3
    log(f"pack_pair_bwd [{label}]: bit-equal to plain and to the "
        f"permute-copy call at {shape}; {ms:.4f} ms (plain {plain_ms:.4f} "
        f"ms, permute-copy {library_ms:.4f} ms), bound {bound_ms:.4f} ms "
        f"({nbytes / 1e6:.1f} MB moved); launches in its run: {launches}")
    return {"pack_pair_bwd": launches}, dict(
        max_abs_err=0.0, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
        bound_by="bytes", library_ms=library_ms)


# the kernel step against the plain step (same weights, batch and draws):
# the forward is bit-equal, the backward differs by the sampling backward's
# sum order and one bf16 rounding of the table gradient, carried through the
# bf16 backbone backward, whose cuDNN weight gradients are themselves not
# run-to-run exact. Loss: 1e-3 relative. Gradients: 5% of each tensor's
# largest entry, the streaming paths' tolerance.
TRAIN_LOSS_RTOL = 1e-3
TRAIN_GRAD_TOL = 5e-2
TRAIN_STEPS = 4
# the EVA02 step takes 12.6 s; two steps hold its loss falling (to make room
# for phase 12 in the run's time)
EVA_TRAIN_STEPS = 2
_LAYER = "pts_bbox_head.transformer.decoder.decoder_layer."
TRAIN_GRAD_PROBES = (
    "img_backbone.layer3.2.conv2.weight", "img_backbone.layer2.1.bn1.weight",
    "img_neck.fpn_convs.0.conv.weight",
    _LAYER + "sampling.sampling_offset.weight",
    _LAYER + "ffn.layers.1.weight", "pts_bbox_head.init_query_bbox.weight")
# eva02: the last block's q projection, the frozen block 2's MLP output
# and the frozen patch embed (their gradients count in the clip), a global
# block's attention output projection, the pyramid's first 1x1 conv, the
# decoder
EVA_TRAIN_GRAD_PROBES = (
    "img_backbone.net.blocks.23.attn.q_proj.weight",
    "img_backbone.net.blocks.2.mlp.w3.weight",
    "img_backbone.net.patch_embed.proj.weight",
    "img_backbone.net.blocks.11.attn.proj.weight",
    "img_backbone.simfp_2.4.weight",
    _LAYER + "sampling.sampling_offset.weight",
    _LAYER + "ffn.layers.1.weight", "pts_bbox_head.init_query_bbox.weight")
# the EVA02 training step's attention shapes: the 24 images of the first
# stop_prev_grad = 4 frames carry gradients; global blocks over 4,000
# tokens a view, windowed ones over 21 padded 16x16 windows a view
EVA_TRAIN_ATTENTION = dict(glb=(24, 4000), win=(24 * 21, 256))
# the trunk gate: the EVA02 backbone's parameter gradients over the step's
# gradient images, kernels against plain versions, same weights, masks and
# cotangent, in the step's compute dtype (bf16). The attention kernels
# differ from their plain versions by about 2e-6 of the scale (forward and
# backward), carried through 24 blocks; the patch embed and the pyramid's
# convolutions round to bf16, where a trunk value that moves by an ulp can
# round the other way (one bf16 ulp is 3.9e-3): 1% of each parameter's
# largest gradient entry. A wrong backward (a missing term, a wrong scale,
# a dropped tile) moves whole tensors. The same comparison with
# compute_dtype float32 is printed, not held: its pyramid outputs agree
# within 6.3e-6 of their scale, but each parameter gradient sums 96,000
# token contributions of a random cotangent that cancel, which lifts those
# fp32 differences to 5e-4 - 2.7e-3 of the gradient's largest entry on an
# H100 (PERF.md, section 6: a 1e-3 stated before that run did not hold)
TRUNK_GRAD_TOL = 1e-2
# vov99: a conv of the last stage-4 block, the frozen stage 2's concat BN
# and stem (their gradients count in the clip), the FPN, the decoder
VOV_TRAIN_GRAD_PROBES = (
    "img_backbone.stage4.OSA4_9.layers.4.OSA4_9_4/conv.weight",
    "img_backbone.stage2.OSA2_1.concat.OSA2_1_concat/norm.weight",
    "img_backbone.stem.stem_1/conv.weight",
    "img_neck.fpn_convs.0.conv.weight",
    _LAYER + "sampling.sampling_offset.weight",
    _LAYER + "ffn.layers.1.weight", "pts_bbox_head.init_query_bbox.weight")


def make_host_batch(cfg, seed=0):
    """A seeded synthetic training batch at the config's full size, as the
    numpy arrays a loader yields: T * 6 uint8 images, six cameras repeated
    over the frames, 0.5 s between frames, ``max_gt`` ground-truth slots of
    which 30 hold boxes inside the point-cloud range."""
    import numpy as np
    head = cfg.model["pts_bbox_head"]
    t = head["num_frames"]
    image_h, image_w = cfg.ida_aug_conf["final_dim"]
    pc = head["pc_range"]
    max_gt, valid = cfg.max_gt, 30
    rng = np.random.default_rng(seed)
    cams = make_cameras(np.random.RandomState(seed), image_h, image_w)
    img = rng.integers(0, 256, (1, t * 6, image_h, image_w, 3), dtype=np.uint8)
    l2i = np.tile(cams[None], (1, t, 1, 1)).reshape(1, t * 6, 4, 4)
    td = (np.arange(t, dtype=np.float32) * 0.5)[None]
    boxes = np.concatenate([
        rng.uniform(pc[0] * 0.9, pc[3] * 0.9, (1, max_gt, 1)),
        rng.uniform(pc[1] * 0.9, pc[4] * 0.9, (1, max_gt, 1)),
        rng.uniform(pc[2] * 0.6, pc[5] * 0.6, (1, max_gt, 1)),
        rng.uniform(0.5, 5.0, (1, max_gt, 3)),
        rng.uniform(-np.pi, np.pi, (1, max_gt, 1)),
        rng.uniform(-3.0, 3.0, (1, max_gt, 2))], -1).astype(np.float32)
    mask = np.zeros((1, max_gt), bool)
    mask[:, :valid] = True
    boxes[~mask] = 0.0
    # int32 labels, as the loader's collate gives them
    labels = rng.integers(0, head["num_classes"], (1, max_gt)).astype(
        np.int32)
    return dict(img=img, lidar2img=l2i.astype(np.float32), time_diff=td,
                gt_boxes=boxes, gt_labels=labels, gt_mask=mask)


def make_train_batch(torch, dev, cfg, seed=0):
    """:func:`make_host_batch` on the card."""
    return {k: torch.from_numpy(v).to(dev)
            for k, v in make_host_batch(cfg, seed).items()}


def profile_call(torch, fn, record_shapes=False):
    """One call of ``fn`` under torch.profiler: device ops, device busy ms,
    the host wall ms of the profiled call, the top device rows and the
    profile itself."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=record_shapes) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    device = [e for e in prof.key_averages()
              if _dev_us(e) > 0 and str(e.device_type).endswith("CUDA")]
    top = sorted(device, key=_dev_us, reverse=True)[:8]
    return (sum(e.count for e in device),
            sum(_dev_us(e) for e in device) / 1e3, wall,
            [(e.key[:60], _dev_us(e) / 1e3, e.count) for e in top], prof)


def table_gradient_chain(prof, table_numels):
    """The rows of a profiled training step (``record_shapes``) that make
    the packed tables' gradient: the sampling backward kernel and every
    ``aten`` operator with an operand of a table's size (zeroing, adds,
    casts, copies), as (name, device ms, calls); and apart, the pack
    adjoint kernels, which read the finished gradient once a level."""
    import math
    chain, adjoint = [], []
    for e in prof.key_averages(group_by_input_shape=True):
        dev_ms = _dev_us(e) / 1e3
        if dev_ms <= 0:
            continue
        if str(e.device_type).endswith("CUDA"):
            if "msmv_sample_bwd_kernel" in e.key:
                chain.append(("msmv_sample_bwd_kernel", dev_ms, e.count))
            elif "pack" in e.key and "_bwd_kernel" in e.key:
                adjoint.append((e.key[:48], dev_ms, e.count))
            continue
        shapes = [sh for sh in (e.input_shapes or [])
                  if sh and all(isinstance(v, int) for v in sh)]
        if e.key.startswith("aten::") and any(
                math.prod(sh) in table_numels for sh in shapes):
            chain.append((f"{e.key} {shapes}", dev_ms, e.count))
    return chain, adjoint


def log_table_gradient_chain(prof, table_numels, label):
    chain, adjoint = table_gradient_chain(prof, table_numels)
    total = sum(ms_ for _, ms_, _ in chain)
    calls = sum(n for _, _, n in chain)
    log(f"{label}: table-gradient chain of the profiled step: {total:.3f} ms "
        f"in {calls} device calls (the sampling backward kernel and every "
        "operator with a table-sized operand)")
    for key, dev_ms, count in chain + adjoint:
        log(f"{label}:   {dev_ms:9.3f} ms {count:4d} calls  {key}")
    return total


def _train_harness(torch, dev, path=None, probes=TRAIN_GRAD_PROBES):
    """A training config at full width (``path``: one of ``PATHS``, r50 by
    default), a seeded batch and two closures: ``new_state()`` (seeded
    weights, AdamW) and ``run_step(state, record=None)``, one step with the
    step's generator re-seeded (``record`` collects the gradients named in
    ``probes`` just before the clip). Also the element counts of the step's
    packed tables: each level's images (T frames of 6 views) of the FPN's C
    channels (an EVA02 backbone's own pyramid has no neck: its
    ``fpn_out_channels``), y-fold (``[M, H, G, W+1, 2Cg]``) or pair
    (``[M, H, G, W+1, Cg]``)."""
    from sparsebev_tpu_torch.config import Config
    from sparsebev_tpu_torch.models.detector import build_detector
    from sparsebev_tpu_torch.train import optim, step as tstep

    path = path or PATHS[0]
    config = os.path.join(HERE, path["config"])
    cfg = Config.fromfile(config)
    batch = make_train_batch(torch, dev, cfg)
    train_step = tstep.train_step_from_config(cfg)
    neck = cfg.model.get("img_neck")
    c = (neck["out_channels"] if neck is not None
         else cfg.model["img_backbone"]["fpn_out_channels"])
    m = batch["img"].shape[1]
    table_numels = {m * h * (w + 1) * c * k for h, w in path["levels"]
                    for k in (1, 2)}

    def new_state():
        model = build_detector(cfg, device=dev, seed=0)
        opt, sched, _ = optim.optimizer_from_config(model, cfg,
                                                    total_steps=1000)
        return tstep.create_train_state(model, opt, sched)

    def run_step(state, record=None):
        gen = torch.Generator(device=dev).manual_seed(11)
        real_clip = tstep.clip_by_global_norm

        def clip(params, max_norm):
            named = dict(state.model.named_parameters())
            record.update({k: named[k].grad.detach().float().clone()
                           for k in probes})
            return real_clip(params, max_norm)

        if record is not None:
            tstep.clip_by_global_norm = clip
        try:
            _, metrics = train_step(state, batch, generator=gen)
        finally:
            tstep.clip_by_global_norm = real_clip
        return metrics

    return config, cfg, batch, new_state, run_step, table_numels


def _step_ms_and_peak(torch, dev, fn):
    """Host ms of one synchronized call of ``fn`` and the peak memory it
    allocated above what was allocated before it."""
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return ((time.perf_counter() - t0) * 1e3,
            torch.cuda.max_memory_allocated(dev) - before, out)


def training_phase(torch, dev, flush, bw, fp32_rate, path=None,
                   probes=TRAIN_GRAD_PROBES, compare_remat=False,
                   steps=TRAIN_STEPS):
    """A training config at full width (``path``, r50 by default): seeded
    weights, a seeded synthetic batch, ``steps`` optimizer steps on
    the same batch with the same draws (so only the updates change the
    loss), counted launches, one more step under the profiler, the sampling
    backward on one layer's recorded operands, and step 1 again with the
    plain versions. ``compare_remat``: one more step with the decoder's
    layer remat off, for its peak memory and time. An EVA02 backbone adds
    the attention kernels' launches (3 forward calls a block: with
    gradients, recomputed by the block remat, detached; one backward). On a
    path that is not ``exact`` the probed gradients of step 1 are printed,
    not held (the loss is held on every path), beside a probe: step 1 once
    more with the attention's output one fp32 ulp off on ``NUDGE_SHARE`` of
    its entries. Returns the launch counts of the steps, the sampling
    backward's numbers on the recorded layer and the step's figures."""
    from sparsebev_tpu_torch.ops import eva_attention as ea
    from sparsebev_tpu_torch.ops import eva_linear as el
    from sparsebev_tpu_torch.ops import msmv_pack
    from sparsebev_tpu_torch.ops import msmv_sampling as ms

    path = path or PATHS[0]
    name = path["name"]
    label = f"training [{name}]"
    config, cfg, batch, new_state, run_step, table_numels = _train_harness(
        torch, dev, path, probes)
    head = cfg.model["pts_bbox_head"]
    dn = head["query_denoising_groups"] * cfg.max_gt
    bb = cfg.model["img_backbone"]
    eva = bb.get("type") == "EVA02"
    if eva:
        k = cfg.model.get("stop_prev_grad", 0) * 6
        backbone = (f"EVA02 backbone: drop path {bb['drop_path_rate']} "
                    f"(np.linspace over {bb['depth']} blocks), block remat "
                    f"use_act_checkpoint={bb['use_act_checkpoint']}, "
                    f"frozen_blocks={bb['frozen_blocks']}, stop_prev_grad="
                    f"{cfg.model.get('stop_prev_grad', 0)} ({k} of "
                    f"{batch['img'].shape[1]} images with gradients)")
    else:
        backbone = f"backbone with_cp={bb.get('with_cp')}"
    log(f"{label}: {config} (B=1, Q={head['num_query']} + {dn} "
        f"denoising queries, T={head['num_frames']}, "
        f"{tuple(batch['img'].shape[2:4])} images, {head['num_layers']} "
        f"layers, {cfg.model['compute_dtype']} compute / fp32 parameters, "
        f"{backbone}, "
        f"decoder layer remat on, table_yfold {head.get('table_yfold', True)}"
        f", table_gsplit_pack {head.get('table_gsplit_pack', False)}, "
        f"{int(batch['gt_mask'].sum())} of {cfg.max_gt} ground-truth slots "
        f"valid), {steps} steps on one batch")

    n_yfold = sum(path["yfold"])
    n_pair = len(path["yfold"]) - n_yfold
    layers = head["num_layers"]
    counters = dict(pack=msmv_pack.pack_level, sampling=ms.msmv_sampling,
                    sampling_bwd=ms.msmv_sampling_backward,
                    pack_bwd=msmv_pack.pack_level_bwd)
    want = dict(pack=n_yfold, sampling=layers, sampling_bwd=layers,
                pack_bwd=n_yfold)
    if n_pair:
        counters.update(pack_pair=msmv_pack.pack_level_pair,
                        pack_pair_bwd=msmv_pack.pack_level_pair_bwd)
        want.update(pack_pair=n_pair, pack_pair_bwd=n_pair)
    if eva:
        counters.update(attention=ea.eva_attention,
                        attention_bwd=ea.eva_attention_backward,
                        linear=el.eva_linear)
        # seven products a block call
        want.update(attention=3 * bb["depth"], attention_bwd=bb["depth"],
                    linear=21 * bb["depth"])
    held = torch.cuda.memory_allocated(dev)
    state = new_state()
    n_params = sum(p.numel() for p in state.model.parameters())
    torch.cuda.reset_peak_memory_stats(dev)
    recorded = {}
    backward = ms._msmv_sampling_backward_cuda

    def record_backward(packed, loc, sw, gout, grads=None):
        if "operands" not in recorded:
            recorded["operands"] = (
                packed.replace(tables=[t.detach() for t in packed.tables],
                               table_grads=None),
                loc.detach(), sw.detach(), gout.clone())
        return backward(packed, loc, sw, gout, grads)

    kernel_grads, times, losses, norms = {}, [], [], []
    for c in counters.values():
        c.launches = 0
    for i in range(steps):
        if i == steps - 1:      # one layer's operands of the last step
            # (the recorded tables outlive their step: its peak is not the
            # step's own)
            peak = torch.cuda.max_memory_allocated(dev) - held
            ms._msmv_sampling_backward_cuda = record_backward
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            metrics = run_step(state, kernel_grads if i == 0 else None)
        finally:
            ms._msmv_sampling_backward_cuda = backward
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        if i == 0:
            first = {k: float(v) for k, v in metrics.items()}
        losses.append(float(metrics["loss"]))
        norms.append(float(metrics["grad_norm"]))
        if not all(bool(torch.isfinite(v)) for v in metrics.values()):
            fail(f"{label}: non-finite loss or gradient norm at step {i}: "
                 f"{ {k: float(v) for k, v in metrics.items()} }")
    launches = {k: c.launches for k, c in counters.items()}
    log(f"{label}: kernel launches "
        + " ".join(f"{k}={v}" for k, v in launches.items())
        + f" in {steps} steps")
    for k, per_step in want.items():
        if launches[k] != per_step * steps:
            fail(f"{label}: kernel {k} launched {launches[k]} times in "
                 f"{steps} steps, {per_step} a step expected")
    log(f"{label}: loss per step " + " ".join(f"{x:.4f}" for x in losses)
        + "; grad norm " + " ".join(f"{x:.3f}" for x in norms)
        + "; step 1 losses " + " ".join(f"{k}={v:.4f}" for k, v in
                                        first.items() if "loss_" in k))
    if not losses[-1] < losses[0]:
        fail(f"{label}: the loss did not fall on the repeated batch "
             f"({losses[0]:.4f} -> {losses[-1]:.4f})")
    steady = statistics.median(times[1:])
    log(f"{label}: ms/step " + " ".join(f"{x:.1f}" for x in times)
        + f" (median of steps 2..{steps}: {steady:.1f}, host clock, "
        f"smoke timing); {n_params / 1e6:.1f}M parameters; peak memory "
        f"of steps 1..{steps - 1} {peak / 2**30:.2f} GiB above "
        f"{held / 2**30:.2f} GiB held by earlier phases")
    figures = dict(ms_per_step=steady, peak_gib=peak / 2**30)
    if compare_remat:
        decoder = state.model.pts_bbox_head.transformer.decoder
        on_ms, on_peak, _ = _step_ms_and_peak(torch, dev,
                                              lambda: run_step(state))
        decoder.with_cp = False
        try:
            off_ms, off_peak, _ = _step_ms_and_peak(torch, dev,
                                                    lambda: run_step(state))
        finally:
            decoder.with_cp = True
        log(f"{label}: one step's own peak memory (above what the steps "
            f"hold between them) and host ms, decoder layer remat on / off: "
            f"{on_peak / 2**30:.2f} / {off_peak / 2**30:.2f} GiB, "
            f"{on_ms:.1f} / {off_ms:.1f} ms")
        figures.update(step_peak_gib=on_peak / 2**30,
                       no_remat_step_peak_gib=off_peak / 2**30,
                       no_remat_ms=off_ms)
    ops, busy, wall, top, prof = profile_call(
        torch, lambda: run_step(state), record_shapes=True)
    log(f"{label}: one more step under torch.profiler (operand "
        f"shapes recorded): wall {wall:.1f} ms, device busy {busy:.1f} ms "
        f"({100 * busy / wall:.1f}%), {ops} device ops")
    for key, dev_ms, count in top:
        log(f"{label}: {dev_ms:9.3f} ms {count:5d} calls  {key}")
    chain_ms = log_table_gradient_chain(prof, table_numels, label)
    del prof
    figures.update(device_busy_ms=busy, device_ops=ops,
                   table_grad_chain_ms=chain_ms)

    # the sampling backward on one layer's recorded operands
    packed, loc, sw, gout = recorded["operands"]
    del state
    torch.cuda.empty_cache()
    bwd = check_sampling_backward(torch, flush, bw, fp32_rate, packed, loc,
                                  sw, gout, f"{name} train, recorded layer")
    del recorded, packed, loc, sw, gout
    torch.cuda.empty_cache()

    # step 1 again from the same weights with the plain versions on the card
    plain_grads = {}
    state = new_state()
    with plain_versions():
        plain = {k: float(v) for k, v in run_step(state, plain_grads).items()}
    del state
    torch.cuda.empty_cache()
    rel = abs(first["loss"] - plain["loss"]) / abs(plain["loss"])
    exact = path.get("exact", True)
    nudge = {}
    if not exact:
        # the probe: step 1 with the kernels, the attention's output one
        # fp32 ulp off on NUDGE_SHARE of its entries (the same entries in
        # every call, the remat's recompute included)
        every = round(1 / NUDGE_SHARE)
        attention = ea._eva_attention_cuda

        def nudged(q, k, v, with_lse=False):
            out, lse = attention(q, k, v, with_lse)
            flat = out.view(-1)
            idx = torch.arange(0, flat.numel(), every, device=flat.device)
            flat[idx] = torch.nextafter(flat[idx],
                                        torch.full_like(flat[idx], 1e30))
            return out, lse

        nudge_grads = {}
        state = new_state()
        ea._eva_attention_cuda = nudged
        try:
            nudge = {k: float(v) for k, v in
                     run_step(state, nudge_grads).items()}
        finally:
            ea._eva_attention_cuda = attention
        del state
        torch.cuda.empty_cache()
    probe = ""
    if nudge:
        p_rel = abs(first["loss"] - nudge["loss"]) / abs(first["loss"])
        probe = (f"; probe (the attention's output one ulp off on "
                 f"{NUDGE_SHARE:g} of its entries): loss {nudge['loss']:.6f}"
                 f", {p_rel:.3g} from the kernel step")
    log(f"{label}: step 1 with kernels loss {first['loss']:.6f}, with "
        f"the plain versions {plain['loss']:.6f} (relative difference "
        f"{rel:.3g}, tolerance {TRAIN_LOSS_RTOL:g}); grad norm "
        f"{first['grad_norm']:.4f} vs {plain['grad_norm']:.4f}" + probe)
    if not rel <= TRAIN_LOSS_RTOL:
        fail(f"{label}: the kernel step's loss differs from the plain "
             "step's")
    for k in probes:
        a, b = kernel_grads[k], plain_grads[k]
        scale = b.abs().max().item()
        d = (a - b).abs().max().item()
        extra = ""
        if nudge:
            pd = (nudge_grads[k] - a).abs().max().item()
            extra = (f"; probe: {pd:.3g} ({pd / scale:.3g} of the scale) "
                     "from the kernel step")
        log(f"{label}: grad {k}: max|kernel - plain| = {d:.3g} at "
            f"scale {scale:.3g} ({d / scale:.3g} of it; tolerance "
            f"{TRAIN_GRAD_TOL:g}){extra}")
        if exact and (not scale > 0 or not d <= TRAIN_GRAD_TOL * scale):
            fail(f"{label}: gradient of {k} differs between the kernel "
                 "and the plain step")
    return launches, bwd, figures


def eva02_trunk_gate(torch, dev, path, compute_dtype=None):
    """The EVA02 backbone (ViT and pyramid) of ``path``'s config, seeded
    weights as the training phase builds them, forward and backward over
    the step's gradient images (``stop_prev_grad`` frames of 6) of seeded
    N(0, 1) pixels in the compute dtype, drop path on with fixed masks, a seeded
    cotangent on the five pyramid outputs: once with the kernels, once with
    the plain versions. Prints the worst share of each block's parameter
    gradients and the pyramid outputs' gaps; in the config's compute dtype
    every parameter's gradient must lie within ``TRUNK_GRAD_TOL`` of its
    largest entry (``compute_dtype`` replaces the config's, and then the
    comparison is only printed)."""
    from sparsebev_tpu_torch.config import Config
    from sparsebev_tpu_torch.models import layers
    from sparsebev_tpu_torch.models.detector import build_detector
    from sparsebev_tpu_torch.ops import eva_attention as ea
    from sparsebev_tpu_torch.ops import eva_linear as el
    from sparsebev_tpu_torch.utils.device import fp32_precision

    cfg = Config.fromfile(os.path.join(HERE, path["config"]))
    held = compute_dtype is None
    if not held:
        cfg.model["compute_dtype"] = compute_dtype
    images = cfg.model["stop_prev_grad"] * 6
    model = build_detector(cfg, device=dev, seed=0)
    backbone = model.img_backbone
    model.pts_bbox_head = None
    h, w = cfg.ida_aug_conf["final_dim"]
    gen = torch.Generator(device=dev).manual_seed(21)
    x = torch.randn((images, 3, h, w), generator=gen, device=dev).to(
        model.compute_dtype)
    masks = {}
    for blk in backbone.net.blocks:
        for dp in (blk.drop_path_attn, blk.drop_path_mlp):
            if dp.rate > 0:
                masks[(dp.block, dp.site)] = torch.rand(
                    images, generator=gen, device=dev) < 1.0 - dp.rate
    layers.set_drop_path_draws(backbone, lambda b, s, n: masks[(b, s)])
    cots = []

    def run():
        backbone.zero_grad(set_to_none=True)
        with fp32_precision():
            outs = backbone(x, deterministic=False)
            if not cots:
                cots.extend(torch.randn(o.shape, generator=gen, device=dev)
                            for o in outs)
            torch.autograd.backward(outs, cots)
        grads = {k: p.grad for k, p in backbone.named_parameters()}
        return grads, [o.detach() for o in outs]

    t0 = time.perf_counter()
    launches = (ea.eva_attention.launches, ea.eva_attention_backward.launches,
                el.eva_linear.launches)
    kernel_grads, kernel_outs = run()
    torch.cuda.synchronize()
    k_s = time.perf_counter() - t0
    launches = (ea.eva_attention.launches - launches[0],
                ea.eva_attention_backward.launches - launches[1],
                el.eva_linear.launches - launches[2])
    t0 = time.perf_counter()
    with plain_versions():
        plain_grads, plain_outs = run()
    torch.cuda.synchronize()
    p_s = time.perf_counter() - t0
    label = (f"trunk gate [{path['name']}, {images} images, "
             f"{cfg.model['compute_dtype']}]")
    gaps = [((a - b).abs().max() / b.abs().max()).item()
            for a, b in zip(kernel_outs, plain_outs)]
    log(f"{label}: {k_s:.1f} s with the kernels ({launches[0]} attention "
        f"forward, {launches[1]} backward, {launches[2]} product launches), "
        f"{p_s:.1f} s with the "
        f"plain versions; pyramid outputs, max|kernel - plain| / scale: "
        + ", ".join(f"{g:.3g}" for g in gaps))
    worst, groups = 0.0, {}
    for k, b in plain_grads.items():
        a = kernel_grads[k]
        scale = b.abs().max().item()
        share = (a - b).abs().max().item() / scale if scale > 0 else (
            0.0 if a.abs().max().item() == 0 else math.inf)
        group = (".".join(k.split(".")[:3]) if k.startswith("net.blocks.")
                 else k.split(".")[0])
        if share > groups.get(group, (-1.0, ""))[0]:
            groups[group] = (share, k)
        worst = max(worst, share)
    log(f"{label}: worst max|kernel - plain| / scale of each block's "
        f"parameter gradients ("
        + (f"tolerance {TRUNK_GRAD_TOL:g}" if held else "printed, not held")
        + "): "
        + "; ".join(f"{g} {v:.3g}" for g, (v, _) in groups.items()))
    name = max(groups.values())[1]
    log(f"{label}: worst parameter {name}: {worst:.3g} of its scale")
    del model, backbone, kernel_grads, plain_grads, kernel_outs, plain_outs
    torch.cuda.empty_cache()
    if held and not worst <= TRUNK_GRAD_TOL:
        fail(f"{label}: the backbone's gradients with the kernels differ "
             f"from the plain versions' ({name}: {worst:.3g} of its scale)")


def _counters():
    """The launch counters of the r50 training path's four kernels."""
    from sparsebev_tpu_torch.ops import msmv_pack
    from sparsebev_tpu_torch.ops import msmv_sampling as ms
    return dict(pack=msmv_pack.pack_level, sampling=ms.msmv_sampling,
                sampling_bwd=ms.msmv_sampling_backward,
                pack_bwd=msmv_pack.pack_level_bwd)


def _reset(counters):
    for c in counters.values():
        c.launches = 0


def _read(counters):
    return {k: c.launches for k, c in counters.items()}


RUNNER_EPOCHS = 2          # then a resume runs epoch 3
RUNNER_BATCHES = 3         # host batches a epoch (seeds 0, 1, 2)


class _Record:
    """A hook that keeps every step's metrics and host ms (after the
    ``IterTimerHook`` before it has set ``time``)."""

    def __init__(self):
        self.metrics, self.ms = [], []

    def after_iter(self, runner, metrics):
        self.metrics.append(metrics)
        self.ms.append(runner.log_vars.get("time", 0.0) * 1e3)


def runner_phase(torch, dev):
    """The training loop at r50 full width: a ``Runner`` over a loader of
    ``RUNNER_BATCHES`` seeded host batches with the timer, text logger,
    checkpoint (``max_keep_ckpts=1``) and sampler-seed hooks for
    ``RUNNER_EPOCHS`` epochs, then a fresh ``Runner`` on other weights that
    resumes from the latest checkpoint and runs one more epoch. Checks the
    pruning, the step after the resume and at the end, the resumed weights
    bit for bit, finite losses and the kernels' launches a step. Returns the
    launch counts and the loop's figures."""
    import shutil
    from sparsebev_tpu_torch.config import Config
    from sparsebev_tpu_torch.models.detector import build_detector
    from sparsebev_tpu_torch.train import hooks as H
    from sparsebev_tpu_torch.train import optim, step as tstep
    from sparsebev_tpu_torch.train.runner import Runner
    from sparsebev_tpu_torch.utils import checkpoint_io
    from sparsebev_tpu_torch.utils.logging import init_logging

    label = "training loop [r50]"
    path = PATHS[0]
    cfg = Config.fromfile(os.path.join(HERE, path["config"]))
    loader = [make_host_batch(cfg, seed) for seed in range(RUNNER_BATCHES)]
    work_dir = os.path.join(HERE, "outputs", "chip_smoke_runner")
    shutil.rmtree(work_dir, ignore_errors=True)
    total = (RUNNER_EPOCHS + 1) * RUNNER_BATCHES
    train_step = tstep.train_step_from_config(cfg)
    schedule = optim.cosine_warmup_schedule(
        cfg.optimizer["lr"], total, cfg.lr_config.get("warmup_iters", 500),
        cfg.lr_config.get("warmup_ratio", 1 / 3),
        cfg.lr_config.get("min_lr_ratio", 1e-3))

    def new_state(seed):
        model = build_detector(cfg, device=dev, seed=seed)
        opt, sched, _ = optim.optimizer_from_config(model, cfg, total)
        return tstep.create_train_state(model, opt, sched)

    save_s = []

    class TimedCheckpointHook(H.CheckpointHook):
        def after_epoch(self, runner):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            super().after_epoch(runner)
            save_s.append(time.perf_counter() - t0)

    def runner(state, epochs, record):
        return Runner(train_step, state, loader, work_dir,
                      total_epochs=epochs, lr_schedule=schedule,
                      hooks=[H.IterTimerHook(), H.TextLoggerHook(interval=1),
                             TimedCheckpointHook(max_keep_ckpts=1),
                             H.SamplerSeedHook(), record],
                      device=dev, seed=0)

    counters = _counters()
    head = cfg.model["pts_bbox_head"]
    levels, layers = head["num_levels"], head["num_layers"]
    want = dict(pack=levels, sampling=layers, sampling_bwd=layers,
                pack_bwd=levels)
    init_logging()
    log(f"{label}: Runner over {RUNNER_BATCHES} seeded host batches (numpy, "
        f"uploaded through pinned memory), {RUNNER_EPOCHS} epochs, hooks "
        f"IterTimer, TextLogger(interval=1), Checkpoint(max_keep_ckpts=1), "
        f"SamplerSeed; work dir {os.path.relpath(work_dir, HERE)}")
    first = _Record()
    run1 = runner(new_state(0), RUNNER_EPOCHS, first)
    _reset(counters)
    run1.run()
    launches = _read(counters)
    steps = RUNNER_EPOCHS * RUNNER_BATCHES
    for k, per_step in want.items():
        if launches[k] != per_step * steps:
            fail(f"{label}: kernel {k} launched {launches[k]} times in "
                 f"{steps} steps, {per_step} a step expected")
    saved = {k: v.detach().cpu().clone()
             for k, v in run1.state.model.state_dict().items()}
    kept = sorted(f for f in os.listdir(work_dir) if f.startswith("ckpt_"))
    latest = checkpoint_io.latest_checkpoint(work_dir)
    if kept != [f"ckpt_{steps}.pth"] or latest is None:
        fail(f"{label}: checkpoints left after pruning: {kept}")
    size_mb = os.path.getsize(latest) / 1e6
    upload_ms = []
    for batch in loader:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run1.upload(batch)
        torch.cuda.synchronize()
        upload_ms.append((time.perf_counter() - t0) * 1e3)
    del run1
    torch.cuda.empty_cache()

    second = _Record()
    run2 = runner(new_state(1), RUNNER_EPOCHS + 1, second)
    t0 = time.perf_counter()
    run2.resume(latest)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    if run2.global_step != steps or run2.epoch != RUNNER_EPOCHS:
        fail(f"{label}: resume reads step {run2.global_step}, epoch "
             f"{run2.epoch}; {steps}, {RUNNER_EPOCHS} expected")
    differ = [k for k, v in run2.state.model.state_dict().items()
              if not torch.equal(v.cpu(), saved[k])]
    if differ:
        fail(f"{label}: {len(differ)} tensors differ after the resume from "
             f"the saved ones, e.g. {differ[:3]}")
    run2.run()
    if run2.global_step != total:
        fail(f"{label}: the step reads {run2.global_step} at the end, "
             f"{total} expected")
    losses = [m["loss"] for m in first.metrics + second.metrics]
    if len(losses) != total or not all(
            math.isfinite(v) for m in first.metrics + second.metrics
            for v in m.values()):
        fail(f"{label}: {len(losses)} steps, losses {losses}")
    del run2
    torch.cuda.empty_cache()
    ms_step = statistics.median(first.ms[1:] + second.ms[1:])
    log(f"{label}: kernel launches in the first {steps} steps "
        + " ".join(f"{k}={v}" for k, v in launches.items())
        + f"; one checkpoint left after pruning ({os.path.basename(latest)},"
        f" {size_mb:.1f} MB); the step reads {steps} after the resume and "
        f"{total} at the end; the resumed weights equal the saved ones bit "
        f"for bit")
    log(f"{label}: loss per step " + " ".join(f"{x:.4f}" for x in losses))
    log(f"{label}: ms/step (IterTimerHook, host clock) "
        + " ".join(f"{x:.1f}" for x in first.ms + second.ms)
        + f" (median without each run's first: {ms_step:.1f}); upload of a "
        f"batch {statistics.median(upload_ms):.2f} ms (median of "
        f"{len(upload_ms)}); checkpoint save "
        + " / ".join(f"{x:.2f}" for x in save_s)
        + f" s, load (resume) {load_s:.2f} s")
    return launches, dict(ms_per_step=ms_step,
                          upload_ms=statistics.median(upload_ms),
                          checkpoint_mb=size_mb, save_s=max(save_s),
                          load_s=load_s)


# the data path's synthetic datasets: nuScenes' camera size, 7 sweeps between
# keyframes so that the r50 sweep loader takes 8 real frames (48 JPEGs) a
# sample; train and val from two seeds
DATA_IMAGE_HW = (900, 1600)
DATA_SWEEPS_BETWEEN = 7
DATA_SAMPLES = dict(train=4, val=3)
DATA_EPOCHS = 1
# the device-busy window: two steps after the first, inside epoch 1
PROFILED_STEPS = (3, 4)


def _tree_bytes(root):
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, fs in os.walk(root) for f in fs)


class _WatchTraining:
    """A hook that keeps, step by step, the metrics, the ``IterTimerHook``'s
    ``time`` and ``data_time`` and the kernels' launches; the launches of
    the ``EvalHook`` (which fires before it at an epoch's end) apart; and a
    torch.profiler trace of ``PROFILED_STEPS`` (device busy share)."""

    def __init__(self, torch, counters):
        self.torch, self.counters = torch, counters
        self.metrics, self.ms, self.data_ms, self.launches = [], [], [], []
        self.eval_launches = {}
        self.prof, self.wall_ms = None, None
        self._last = {}

    def before_run(self, runner):
        self._last = _read(self.counters)

    def _since_last(self):
        now = _read(self.counters)
        diff = {k: now[k] - self._last[k] for k in now}
        self._last = now
        return diff

    def after_iter(self, runner, metrics):
        self.metrics.append(metrics)
        self.ms.append(runner.log_vars.get("time", 0.0) * 1e3)
        self.data_ms.append(runner.log_vars.get("data_time", 0.0) * 1e3)
        self.launches.append(self._since_last())
        step = runner.global_step
        if step == PROFILED_STEPS[0] - 1:
            from torch.profiler import ProfilerActivity, profile
            self.torch.cuda.synchronize()
            self.prof = profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA])
            self.prof.start()
            self._t0 = time.perf_counter()
        elif step == PROFILED_STEPS[-1]:
            self.torch.cuda.synchronize()
            self.wall_ms = (time.perf_counter() - self._t0) * 1e3
            self.prof.stop()        # its rows are read after the run

    def busy(self):
        """Device busy ms, device ops and wall ms of the profiled steps."""
        device = [e for e in self.prof.key_averages()
                  if _dev_us(e) > 0 and str(e.device_type).endswith("CUDA")]
        return dict(wall_ms=self.wall_ms, ops=sum(e.count for e in device),
                    busy_ms=sum(_dev_us(e) for e in device) / 1e3)

    def after_epoch(self, runner):
        diff = self._since_last()
        if any(diff.values()):
            self.eval_launches = diff


def val_with_gt_config(root):
    """Write under ``root`` the r50 config with a val split that keeps its
    ground truth through the pipeline (as configs/smoke_synthetic.py does),
    so that the evaluator has boxes to score; everything else is the
    config's own. Returns its path."""
    from sparsebev_tpu_torch.config import Config
    base = os.path.join(HERE, PATHS[0]["config"])
    val_pipeline = [dict(p) for p in Config.fromfile(base).test_pipeline]
    val_pipeline[-1]["keys"] = ["gt_bboxes_3d", "gt_labels_3d", "img"]
    config = os.path.join(root, "r50_synthetic_val_with_gt.py")
    with open(config, "w") as f:
        f.write(f"_base_ = [{base!r}]\n"
                f"data = dict(val=dict(test_mode=False, "
                f"pipeline={val_pipeline!r}))\n")
    return config


def data_path_phase(torch, dev, preloaded_ms):
    """The host data path and the two CLIs at r50 full width, from JPEGs on
    disk: two synthetic nuScenes-format datasets (train and val, 1600x900,
    7 sweeps between keyframes), the r50 config with its val split keeping
    the ground truth, one epoch of the train loader alone, then
    ``tools/train.main`` (``DATA_EPOCHS`` epochs of batch 1, the EvalHook on
    the val set at the last epoch, a checkpoint) and ``tools/val.main``
    offline and ``--online`` on that checkpoint. Each CLI run's launches
    are reset just before it and read just after. Returns the launch
    counts of the three runs and the phase's figures."""
    import shutil
    import numpy as np
    from sparsebev_tpu_torch.builder import build_dataloader, build_dataset
    from sparsebev_tpu_torch.config import Config
    from sparsebev_tpu_torch.data import fastloader, make_synthetic_dataset
    from sparsebev_tpu_torch.tools import train as train_cli
    from sparsebev_tpu_torch.tools import val as val_cli

    label = "data path [r50]"
    path = PATHS[0]
    root = os.path.join(HERE, "outputs", "chip_smoke_data")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    config = val_with_gt_config(root)
    cfg = Config.fromfile(config)
    anns = {}
    for seed, (split, n) in enumerate(DATA_SAMPLES.items()):
        t0 = time.perf_counter()
        anns[split] = make_synthetic_dataset(
            os.path.join(root, split), num_samples=n,
            sweeps_between=DATA_SWEEPS_BETWEEN, image_hw=DATA_IMAGE_HW,
            seed=seed)
        sec = time.perf_counter() - t0
        jpegs = len(os.listdir(os.path.join(root, split, "imgs")))
        log(f"{label}: wrote the {split} set: {n} samples, {jpegs} JPEGs of "
            f"{DATA_IMAGE_HW[1]}x{DATA_IMAGE_HW[0]}, "
            f"{_tree_bytes(os.path.join(root, split)) / 1e6:.1f} MB in "
            f"{sec:.1f} s ({os.path.relpath(anns[split], HERE)})")

    # the train loader alone, as the config builds it
    workers = cfg.data.get("workers_per_gpu", 4)
    dataset = build_dataset(dict(cfg.data["train"], ann_file=anns["train"]))
    t0 = time.perf_counter()
    np.random.seed(0)
    dataset[1]
    one_ms = (time.perf_counter() - t0) * 1e3
    loader = build_dataloader(dataset, batch_size=1, num_workers=workers,
                              shuffle=True, seed=0, max_gt=cfg.max_gt)
    t0 = time.perf_counter()
    batches = list(loader)
    sec = time.perf_counter() - t0
    ref = make_host_batch(cfg)
    first = batches[0]
    log(f"{label}: train loader alone: {len(batches)} samples in {sec:.2f} s "
        f"= {len(batches) / sec:.2f} samples/s, {sec * 1e3 / len(batches):.1f}"
        f" ms a sample ({workers} threads, prefetch {loader.prefetch} "
        f"batches); one sample on one thread {one_ms:.1f} ms; JPEG decoder "
        f"{fastloader.decoder()}; os.cpu_count() {os.cpu_count()}")
    log(f"{label}: collated batch: " + ", ".join(
        f"{k} {tuple(v.shape)} {v.dtype}" for k, v in first.items()
        if hasattr(v, "shape")))
    for k, v in ref.items():
        got = first[k]
        if got.shape != v.shape or got.dtype != v.dtype:
            fail(f"{label}: the loader's {k} is {got.shape} {got.dtype}, "
                 f"make_host_batch's {v.shape} {v.dtype}")
    loader_sps = len(batches) / sec
    del batches, first

    # the training CLI, in-process
    counters = _counters()
    work = os.path.join(root, "work")
    watch = _WatchTraining(torch, counters)
    argv = ["--config", config, "--work-dir", work, "--batch-size", "1",
            "--epochs", str(DATA_EPOCHS), "--override",
            f"data.train.ann_file={anns['train']}",
            f"data.val.ann_file={anns['val']}",
            f"data.train.data_root={os.path.dirname(anns['train'])}",
            f"data.val.data_root={os.path.dirname(anns['val'])}",
            f"checkpoint_config.interval={DATA_EPOCHS}",
            "checkpoint_config.max_keep_ckpts=1",
            f"eval_config.interval={DATA_EPOCHS}"]
    log(f"{label}: python -m sparsebev_tpu_torch.tools.train "
        + " ".join(os.path.relpath(a, HERE) if a.startswith(HERE) else a
                   for a in argv))
    _reset(counters)
    t0 = time.perf_counter()
    runner = train_cli.main(argv, extra_hooks=[watch])
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    train_launches = _read(counters)
    steps = DATA_EPOCHS * DATA_SAMPLES["train"]
    head = cfg.model["pts_bbox_head"]
    want = dict(pack=head["num_levels"], sampling=head["num_layers"],
                sampling_bwd=head["num_layers"], pack_bwd=head["num_levels"])
    if runner.global_step != steps or len(watch.metrics) != steps:
        fail(f"{label}: the train CLI took {runner.global_step} steps, "
             f"{steps} expected")
    for i, per_step in enumerate(watch.launches):
        if per_step != want:
            fail(f"{label}: step {i + 1} launched {per_step}, {want} "
                 "expected")
    if not all(math.isfinite(v) for m in watch.metrics for v in m.values()):
        fail(f"{label}: losses {[m['loss'] for m in watch.metrics]}")
    ckpts = sorted(f for f in os.listdir(work) if f.startswith("ckpt_"))
    if ckpts != [f"ckpt_{steps}.pth"]:
        fail(f"{label}: checkpoints {ckpts}")
    metrics = runner.eval_results
    if not metrics or not {"NDS", "mAP"} <= set(metrics) or not all(
            math.isfinite(v) for v in metrics.values()):
        fail(f"{label}: the EvalHook returned {metrics}")
    if not all(watch.eval_launches.get(k, 0) > 0
               for k in ("pack", "sampling")):
        fail(f"{label}: the EvalHook launched {watch.eval_launches}")
    ckpt = os.path.join(work, ckpts[0])
    del runner
    torch.cuda.empty_cache()
    # steady steps: not an epoch's first (the loader starts again), not the
    # profiled ones nor the one after them (the profiler's teardown)
    per_epoch = DATA_SAMPLES["train"]
    steady = [i for i in range(steps) if i % per_epoch != 0
              and i + 1 not in PROFILED_STEPS
              and i != PROFILED_STEPS[-1]]
    ms_step = statistics.median(watch.ms[i] for i in steady)
    wall_step = statistics.mean(watch.ms[i] + watch.data_ms[i]
                                for i in steady)
    busy = watch.busy()
    log(f"{label}: train CLI: {steps} steps in {train_s:.1f} s (model build, "
        f"loader, steps, checkpoint and EvalHook); launches a step "
        + " ".join(f"{k}={v}" for k, v in want.items())
        + f" (every step), in the EvalHook "
        + " ".join(f"{k}={v}" for k, v in watch.eval_launches.items()))
    log(f"{label}: loss per step "
        + " ".join(f"{m['loss']:.4f}" for m in watch.metrics))
    log(f"{label}: ms/step (IterTimerHook, host clock) "
        + " ".join(f"{x:.1f}" for x in watch.ms)
        + f"; of which data_time (loader wait + upload) "
        + " ".join(f"{x:.1f}" for x in watch.data_ms)
        + f"; steps {[i + 1 for i in steady]}: {ms_step:.1f} ms/step (median "
        f"time) from JPEGs against {preloaded_ms:.1f} on preloaded batches "
        f"(training loop phase); with the loader wait {wall_step:.1f} ms/step"
        " (mean time + data_time)")
    log(f"{label}: steps {PROFILED_STEPS[0]}-{PROFILED_STEPS[-1]} under "
        f"torch.profiler: wall {busy['wall_ms']:.1f} ms, device busy "
        f"{busy['busy_ms']:.1f} ms ({100 * busy['busy_ms'] / busy['wall_ms']:.1f}"
        f"%), idle {100 - 100 * busy['busy_ms'] / busy['wall_ms']:.1f}%, "
        f"{busy['ops']} device ops")
    log(f"{label}: EvalHook metrics: " + ", ".join(
        f"{k} {metrics[k]:.4f}" for k in ("NDS", "mAP", "mATE")))

    # the val CLI on that checkpoint, offline then online
    val_argv = ["--config", config, "--weights", ckpt, "--override",
                f"data.val.ann_file={anns['val']}",
                f"data.val.data_root={os.path.dirname(anns['val'])}"]
    launches = {"r50 data path train CLI": train_launches}
    figures = dict(loader_samples_per_s=loader_sps, ms_per_step=ms_step,
                   wall_ms_per_step=wall_step, busy=busy, config=config)
    for mode in ("offline", "online"):
        extra = ["--online"] if mode == "online" else []
        out_json = os.path.join(root, f"submission_{mode}.json")
        if mode == "online":
            extra += ["--out", out_json]
        _reset(counters)
        t0 = time.perf_counter()
        out = val_cli.main(val_argv + extra)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        got = _read(counters)
        launches[f"r50 data path val {mode}"] = {
            k: got[k] for k in ("pack", "sampling")}
        m = out["metrics"]
        if (m is None or not {"NDS", "mAP"} <= set(m)
                or not all(math.isfinite(v) for v in m.values())):
            fail(f"{label}: val {mode} metrics {m}")
        if got["pack"] == 0 or got["sampling"] == 0:
            fail(f"{label}: val {mode} launched {got}")
        n = len(out["results"])
        if n != DATA_SAMPLES["val"]:
            fail(f"{label}: val {mode} decoded {n} samples")
        if mode == "online":
            with open(out_json) as f:
                sub = json.load(f)["results"]
            if sorted(sub) != sorted(out["results"]):
                fail(f"{label}: the submission holds {len(sub)} samples, "
                     f"{n} expected")
        ms_sample = statistics.mean(out["sample_ms"])
        figures[f"val_{mode}_ms"] = ms_sample
        cache = (f"; ring: {out['frames_run']} frames ran the backbone, "
                 f"{out['frames_reused']} were found in the ring"
                 if mode == "online" else "")
        log(f"{label}: val {mode}: {n} samples in {sec:.1f} s; ms a sample "
            "(host clock, synchronized, samples 1..n-1) "
            + " ".join(f"{x:.1f}" for x in out["sample_ms"])
            + f" (mean {ms_sample:.1f}; loader wait "
            + " ".join(f"{x:.1f}" for x in out["wait_ms"][1:])
            + f"); launches pack={got['pack']} sampling={got['sampling']}"
            + f"; metrics {sorted(m)}" + cache
            + (f"; submission {os.path.relpath(out_json, HERE)} holds {n} "
               "samples" if mode == "online" else ""))
        torch.cuda.empty_cache()
    return launches, figures


def jpeg_decoders(cuda_home=None):
    """What this host offers to decode JPEGs: ``import PIL``, the header and
    library that ``csrc/fastloader.cpp`` builds against (``jpeglib.h``,
    ``libjpeg.so*``), and nvJPEG under the CUDA toolkit (``nvjpeg.h``,
    ``libnvjpeg.so*``). One line of facts; nothing here fails."""
    import glob
    import importlib.util
    cuda_home = cuda_home or os.environ.get("CUDA_HOME", "/usr/local/cuda")

    def found(patterns):
        hits = sorted({os.path.realpath(h) for pat in patterns
                       for h in glob.glob(pat)})
        return ", ".join(hits[:3]) + (" ..." if len(hits) > 3 else "") \
            if hits else "none"

    pil = importlib.util.find_spec("PIL")
    if pil is not None:
        import PIL
        pil_msg = f"yes ({PIL.__version__})"
    else:
        pil_msg = "no"
    incdirs = ["/usr/include", "/usr/include/*", "/usr/local/include"]
    libdirs = ["/usr/lib", "/usr/lib64", "/usr/local/lib",
               "/usr/lib/*-linux-gnu", "/lib/*-linux-gnu"]
    # the toolkit, and the CUDA wheels beside torch (nvidia/<lib>/...)
    cuda_dirs = [cuda_home, f"{cuda_home}/targets/*"] + [
        f"{p}/nvidia/*" for p in sys.path if os.path.isdir(f"{p}/nvidia")]
    jpeglib = found([f"{d}/jpeglib.h" for d in incdirs])
    libjpeg = found([f"{d}/libjpeg.so*" for d in libdirs])
    nvjpeg_h = found([f"{d}/include/nvjpeg.h" for d in cuda_dirs])
    libnvjpeg = found([f"{d}/lib*/libnvjpeg.so*" for d in cuda_dirs])
    return (f"import PIL: {pil_msg}; jpeglib.h: {jpeglib}; libjpeg.so*: "
            f"{libjpeg}; nvjpeg.h: {nvjpeg_h}; libnvjpeg.so*: {libnvjpeg}")


def vov99_memory(stem_remat=False, plain=False, steps=2):
    """The vov99 training step's memory on its own (one process a setting):
    builds the four training kernels, runs ``steps`` steps and prints each
    step's host ms and the peak memory above the weights and optimizer
    state. ``stem_remat`` runs the VoVNet stem as one more checkpointed
    region (the model keeps its activations, as the JAX VoVNet does);
    ``plain`` runs the plain versions.
    ``python3 -c "import chip_smoke; chip_smoke.vov99_memory(True)"``."""
    import torch
    from torch.utils.checkpoint import checkpoint
    sys.path.insert(0, HERE)
    from sparsebev_tpu_torch.kernels import build
    dev = torch.device("cuda", 0)
    label = f"vov99_memory [stem remat {stem_remat}, plain {plain}]"
    log(f"{label}: {nvidia_smi_line()}")
    build.build_all(["msmv_pack", "msmv_pack_pair", "msmv_sample",
                     "msmv_sample_bwd"])
    _, _, _, new_state, run_step, _ = _train_harness(
        torch, dev, PATHS[1], VOV_TRAIN_GRAD_PROBES)
    state = new_state()
    if stem_remat:
        backbone = state.model.img_backbone
        layers = list(backbone._stem)

        def stem(x):
            for layer in layers:
                x = layer(x)
            return x

        backbone._stem = [lambda x: checkpoint(
            stem, x, use_reentrant=False, preserve_rng_state=False)]
    held = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    ctx = plain_versions() if plain else contextlib.nullcontext()
    with ctx:
        for i in range(steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss = float(run_step(state)["loss"])
            step_ms = (time.perf_counter() - t0) * 1e3
            log(f"{label}: step {i + 1}: {step_ms:.1f} ms, loss {loss:.4f}, "
                f"peak so far "
                f"{(torch.cuda.max_memory_allocated(dev) - held) / 2**30:.2f} "
                f"GiB above {held / 2**30:.2f} GiB of weights and optimizer")


def bringup_train_kernels():
    """Build the three training kernels alone, print what ptxas reports for
    the sampling backward, run the reduction probe and hold each kernel
    against its plain version at the r50 / vov99 shapes on synthetic
    operands: the short first run of a new or edited kernel (``python3 -c
    "import chip_smoke; chip_smoke.bringup_train_kernels()"``)."""
    import torch
    sys.path.insert(0, HERE)
    from sparsebev_tpu_torch.kernels import build
    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    log(nvidia_smi_line())
    logs = build.build_all(["msmv_pack", "msmv_pack_pair", "msmv_sample_bwd"])
    for r in ptxas_report(logs["msmv_sample_bwd"]):
        log(f"ptxas[msmv_sample_bwd]: {r}")
    bw, fp32_rate, _ = peaks(name)
    flush = torch.empty(64 * 2**20, dtype=torch.int32, device=dev)
    check_reduction_rounding(torch, dev)
    check_pack_bwd(torch, dev, flush, bw)
    check_pack_pair_bwd(torch, dev, flush, bw)
    for dtype in (torch.float32, torch.bfloat16):
        operands = synthetic_train_sampling(torch, dev, dtype)
        check_sampling_backward(torch, flush, bw, fp32_rate, *operands,
                                "r50 train, uniform points",
                                timed=dtype == torch.bfloat16)
        del operands
        torch.cuda.empty_cache()


def bringup_attention():
    """The attention kernels alone: build them, print what ptxas reports
    (failing if a backward kernel spills) and each kernel's tensor-core
    opcodes in the SASS (TF32 HMMA in the forward, TF32 HGMMA and no HMMA in
    the backward's two), hold the forward to its plain version at both
    EVA02 streaming shapes (timed beside SDPA) and the forward with the lse
    and the backward at the training step's shapes (bit-equal twice, timed
    beside SDPA's backward, its three kernels apart), and check the fp32
    conv of the frame pass (``python3 -c "import chip_smoke;
    chip_smoke.bringup_attention()"``)."""
    import torch
    sys.path.insert(0, HERE)
    from sparsebev_tpu_torch.kernels import build
    dev = torch.device("cuda", 0)
    log(nvidia_smi_line())
    logs = build.build_all(["msmv_pack", "msmv_pack_pair", "eva_attention"])
    attention_ptxas(logs["eva_attention"])
    attention_sass(build.library_path("eva_attention"))
    bw, fp32_rate, _ = peaks(torch.cuda.get_device_name(0))
    path = next(p for p in PATHS if p["name"] == "eva02")
    flush = torch.empty(64 * 2**20, dtype=torch.int32, device=dev)
    check_attention(torch, dev, flush, bw, fp32_rate, path)
    check_attention_backward(torch, dev, flush, bw, fp32_rate,
                             EVA_TRAIN_ATTENTION)
    del flush
    torch.cuda.empty_cache()
    check_fp32_conv(torch, dev)


def bringup_eva02():
    """The EVA02 paths alone: build their four sources, print what ptxas
    reports for the attention kernel, hold the attention kernel (both
    shapes) and the sampling kernel (P=8) against their plain versions,
    then stream the EVA02 config as phase 4 does, in bf16 and in fp32 (the
    packs checked on fp32 tables first) (``python3 -c "import chip_smoke;
    chip_smoke.bringup_eva02()"``)."""
    import torch
    sys.path.insert(0, HERE)
    from sparsebev_tpu_torch.kernels import build
    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    log(nvidia_smi_line())
    logs = build.build_all(["msmv_pack", "msmv_pack_pair", "msmv_sample",
                            "eva_attention"])
    attention_ptxas(logs["eva_attention"])
    bw, fp32_rate, _ = peaks(name)
    path = next(p for p in PATHS if p["name"] == "eva02")
    flush = torch.empty(64 * 2**20, dtype=torch.int32, device=dev)
    check_attention(torch, dev, flush, bw, fp32_rate, path)
    check_sampling(torch, dev, flush, bw, fp32_rate, path)
    for p in PATHS:
        if not p["name"].startswith("eva02"):
            continue
        t0 = time.perf_counter()
        for k in p.get("checks", ()):
            if k in ("pack", "pack_pair") and p is not path:
                _CHECKS[k](torch, dev, flush, bw, p)
        launches, _, _ = streaming_phase(torch, dev, p)
        log(f"{p['name']} stream: launches {launches}; "
            f"{time.perf_counter() - t0:.1f} s")
    del flush


def eva02_training(torch, dev, flush, bw, fp32_rate, measured):
    """Phase 10: the attention backward at the EVA02 step's shapes
    (``check_attention_backward``), the trunk gate and the training phase of
    the EVA02 config; its numbers go into ``measured``. Returns the step's
    launch counts."""
    path = next(p for p in PATHS if p["name"] == "eva02")
    measured["attention_bwd"].update(check_attention_backward(
        torch, dev, flush, bw, fp32_rate, EVA_TRAIN_ATTENTION))
    eva02_trunk_gate(torch, dev, path)                  # held
    eva02_trunk_gate(torch, dev, path, "float32")       # printed
    launches, measured["sampling_bwd"]["eva02 train recorded"], _ = \
        training_phase(torch, dev, flush, bw, fp32_rate, path,
                       EVA_TRAIN_GRAD_PROBES, steps=EVA_TRAIN_STEPS)
    return launches


def r101_training(torch, dev, flush, bw, fp32_rate, measured):
    """The training phase of the r101 config at full width (48 images of
    1408x512, ``with_cp`` over the 33 bottlenecks, the decoder's layer
    remat; 5 packs, 6 sampling calls, 6 sampling backwards and 5 pack
    adjoints a step), then the pack adjoint at the step's 5 levels against
    its plain version; the numbers go into ``measured``. Returns the step's
    launch counts."""
    path = next(p for p in PATHS if p["name"] == "r101")
    launches, measured["sampling_bwd"]["r101 train recorded"], _ = \
        training_phase(torch, dev, flush, bw, fp32_rate, path,
                       TRAIN_GRAD_PROBES)
    measured["pack_bwd"]["r101 train"] = check_pack_bwd(
        torch, dev, flush, bw, levels=path["levels"], m=path["t"] * 6,
        label="r101 train")
    return launches


FP8_DRIFT_SAMPLES = 4


def fp8_drift_phase(torch):
    """The port's fp8 drift tool at vov99 (``tools/fp8_drift.py``: a bf16
    ring and a y-fold fp8-L0 ring over the same synthetic frames, one after
    the other): its JSON line is printed, not held. With seeded weights the
    head amplifies any change of its input (PERF.md, section 7, fault 1)."""
    from sparsebev_tpu_torch.tools import fp8_drift
    config = next(p for p in PATHS if p["name"] == "vov99")["config"]
    report = fp8_drift.main(["--config", os.path.join(HERE, config),
                             "--samples", str(FP8_DRIFT_SAMPLES)])
    log(f"fp8 drift [vov99]: {json.dumps(report)} (printed, not held)")
    torch.cuda.empty_cache()


def bringup_slice14():
    """What the r101 and fp8-ring slice adds, alone: build the pack and
    sampling sources, print what ptxas reports for the sampling kernel,
    check the sampling kernel's bf16 route at r50 / vov99 / r101 shapes and
    its e4m3 route (``check_sampling_e4m3``), stream the vov99 fp8l0 and
    r101 paths, run the fp8 drift tool and the r101 training phase
    (``python3 -c "import chip_smoke; chip_smoke.bringup_slice14()"``)."""
    import torch
    sys.path.insert(0, HERE)
    from sparsebev_tpu_torch.kernels import build
    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    log(nvidia_smi_line())
    logs = build.build_all(["msmv_pack", "msmv_pack_pair", "msmv_sample",
                            "msmv_sample_bwd"])
    for r in ptxas_report(logs["msmv_sample"]):
        log(f"ptxas[msmv_sample]: {r['kernel']}: {r['regs']} registers, "
            f"{r['stack']} bytes stack frame, spills {r['spill_stores']} / "
            f"{r['spill_loads']} bytes")
    bw, fp32_rate, _ = peaks(name)
    flush = torch.empty(64 * 2**20, dtype=torch.int32, device=dev)
    measured = {k: {} for k in KERNELS}
    for pname in ("r50", "vov99", "r101"):
        path = next(p for p in PATHS if p["name"] == pname)
        check_sampling(torch, dev, flush, bw, fp32_rate, path)
    check_pack(torch, dev, flush, bw, next(p for p in PATHS
                                          if p["name"] == "r101"))
    check_sampling_e4m3(torch, dev, flush, bw, fp32_rate)
    for pname in ("vov99 fp8l0", "r101"):
        t0 = time.perf_counter()
        launches, _, _ = streaming_phase(
            torch, dev, next(p for p in PATHS if p["name"] == pname))
        log(f"{pname} stream: launches {launches}; "
            f"{time.perf_counter() - t0:.1f} s")
    fp8_drift_phase(torch)
    t0 = time.perf_counter()
    launches = r101_training(torch, dev, flush, bw, fp32_rate, measured)
    log(f"r101 train: launches {launches}; {time.perf_counter() - t0:.1f} s")


def bringup_slice15():
    """What the chunk-split and parallelism slice adds, alone: build the
    pack and sampling sources, print what ptxas reports for the sampling
    kernel, check its unsplit route at r50 / vov99 shapes and its e4m3 and
    split routes (``check_sampling_split``), stream the r50 split path,
    then phase 12 on a small synthetic train set (``python3 -c "import
    chip_smoke; chip_smoke.bringup_slice15()"``)."""
    import torch
    sys.path.insert(0, HERE)
    from sparsebev_tpu_torch.kernels import build
    dev = torch.device("cuda", 0)
    log(nvidia_smi_line())
    logs = build.build_all(["msmv_pack", "msmv_pack_pair", "msmv_sample",
                            "msmv_sample_bwd"])
    for r in ptxas_report(logs["msmv_sample"]):
        log(f"ptxas[msmv_sample]: {r['kernel']}: {r['regs']} registers, "
            f"{r['stack']} bytes stack frame, spills {r['spill_stores']} / "
            f"{r['spill_loads']} bytes")
    bw, fp32_rate, _ = peaks(torch.cuda.get_device_name(0))
    flush = torch.empty(64 * 2**20, dtype=torch.int32, device=dev)
    for pname in ("r50", "vov99"):
        check_sampling(torch, dev, flush, bw, fp32_rate,
                       next(p for p in PATHS if p["name"] == pname))
    check_sampling_e4m3(torch, dev, flush, bw, fp32_rate)
    check_sampling_split(torch, dev, flush, bw, fp32_rate)
    del flush
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    launches, _, _ = streaming_phase(
        torch, dev, next(p for p in PATHS if p["name"] == "r50 split"))
    log(f"r50 split stream: launches {launches}; "
        f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    launches = parallel_phase(torch, dev,
                              os.path.join(HERE, PATHS[0]["config"]))
    log(f"parallelism: launches {launches}; "
        f"{time.perf_counter() - t0:.1f} s")


def bringup_slice16():
    """What the side-module slice adds, alone: build the pack and sampling
    sources, print what ptxas reports for the sampling kernel, check its
    fp32 route at r50 and its e4m3 routes (case (d): e4m3 beside fp32
    levels), stream the r50 fp32 fp8l0 path, run the choice probe of the
    data-parallel step (the batch of 2 against its halves, bf16 and fp32)
    and phase 13 (``python3 -c "import chip_smoke;
    chip_smoke.bringup_slice16()"``)."""
    import torch
    sys.path.insert(0, HERE)
    from sparsebev_tpu_torch.kernels import build
    dev = torch.device("cuda", 0)
    log(nvidia_smi_line())
    t0 = time.perf_counter()
    logs = build.build_all(["msmv_pack", "msmv_pack_pair", "msmv_sample",
                            "msmv_sample_bwd"])
    log(f"build: 4 sources in {time.perf_counter() - t0:.1f} s")
    for r in ptxas_report(logs["msmv_sample"]):
        log(f"ptxas[msmv_sample]: {r['kernel']}: {r['regs']} registers, "
            f"{r['stack']} bytes stack frame, spills {r['spill_stores']} / "
            f"{r['spill_loads']} bytes")
    bw, fp32_rate, _ = peaks(torch.cuda.get_device_name(0))
    flush = torch.empty(64 * 2**20, dtype=torch.int32, device=dev)
    check_sampling(torch, dev, flush, bw, fp32_rate, PATHS[0])
    check_sampling_e4m3(torch, dev, flush, bw, fp32_rate)
    del flush
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    launches, _, _ = streaming_phase(
        torch, dev, next(p for p in PATHS if p["name"] == "r50 fp32 fp8l0"))
    log(f"r50 fp32 fp8l0 stream: launches {launches}; "
        f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    for fp32 in (False, True):
        one, halves = {}, [{}, {}]
        dp_halves(torch, dev, fp32, records=halves)
        dp_step(torch, dev, fp32=fp32, record=one)
        log_choice_probe("parallel [r50]", "fp32" if fp32 else "bf16", one,
                         halves)
        torch.cuda.empty_cache()
    log(f"probe: {time.perf_counter() - t0:.1f} s")
    launches = {}
    side_phases(torch, dev, launches)
    log(f"phase 13 launches: {launches}")


def bringup_eva02_train():
    """The EVA02 training phase alone: build its five sources, print what
    ptxas reports for the attention kernels, then phase 10 (``python3 -c
    "import chip_smoke; chip_smoke.bringup_eva02_train()"``)."""
    import torch
    sys.path.insert(0, HERE)
    from sparsebev_tpu_torch.kernels import build
    dev = torch.device("cuda", 0)
    log(nvidia_smi_line())
    t0 = time.perf_counter()
    logs = build.build_all(["msmv_pack", "msmv_pack_pair", "msmv_sample",
                            "msmv_sample_bwd", "eva_attention"])
    attention_ptxas(logs["eva_attention"])
    bw, fp32_rate, _ = peaks(torch.cuda.get_device_name(0))
    flush = torch.empty(64 * 2**20, dtype=torch.int32, device=dev)
    measured = {k: {} for k in KERNELS}
    launches = eva02_training(torch, dev, flush, bw, fp32_rate, measured)
    log(f"eva02 train: launches {launches}; "
        f"{time.perf_counter() - t0:.1f} s")


def backward_ab(other, reps=10):
    """The attention backward of this checkout against the one of the
    checkout at ``other`` (another commit unpacked with ``git archive``
    into a gitignored directory), on one card at the training step's two
    shapes: both held to the plain version, then timed in turns (other,
    this, this, other; CUDA events, L2 flushed, median of ``reps`` calls
    each) (``python3 -c "import chip_smoke;
    chip_smoke.backward_ab('outputs/parent')"``)."""
    import ctypes
    import torch
    sys.path.insert(0, HERE)
    from sparsebev_tpu_torch.ops import eva_attention as ea
    dev = torch.device("cuda", 0)
    log(f"backward_ab [{other}]: {nvidia_smi_line()}")
    lib = other_library(other, "eva_attention")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.eva_attention_backward.argtypes = [vp] * 10 + [ci] * 4 + [vp]
    lib.eva_attention_backward.restype = ci
    scratch = getattr(lib, "eva_attention_backward_scratch", None)
    if scratch is not None:
        scratch.argtypes, scratch.restype = [ci], ci

    def other_backward(q, k, v, o, lse, g):
        b, n, heads, hd = q.shape
        grads = [torch.empty_like(q) for _ in range(3)]
        # the scratch a (batch, head): [n] floats of D before the wgmma
        # redesign, the library's own count since
        per = scratch(n) if scratch is not None else n
        tmp = torch.empty(b * heads * per, dtype=torch.float32, device=dev)
        rc = lib.eva_attention_backward(
            *(x.data_ptr() for x in (q, k, v, o, lse, g, *grads)),
            tmp.data_ptr(), b, n, heads, hd,
            torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            fail(f"the other checkout's backward returned CUDA error {rc}")
        return grads

    flush = torch.empty(64 * 2**20, dtype=torch.int32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(6)
    for key, (b, n) in EVA_TRAIN_ATTENTION.items():
        q, k, v, g = (torch.randn((b, n, 16, 64), generator=gen, device=dev)
                      for _ in range(4))
        out, lse = ea._eva_attention_cuda(q, k, v, with_lse=True)
        plain = ea.eva_attention_backward_plain(q, k, v, out, lse, g)
        errs = {}
        for label, fn in (("other", other_backward),
                          ("this", ea._eva_attention_backward_cuda)):
            got = fn(q, k, v, out, lse, g)
            errs[label] = max(((a - p_).abs().max() / p_.abs().max()).item()
                              for a, p_ in zip(got, plain))
            del got
        del plain
        if not max(errs.values()) <= ea.ATTENTION_BWD_TOL:
            fail(f"backward_ab [{key}]: a backward differs from the plain "
                 f"version: {errs}")
        runs = [(label, time_ms(torch, lambda fn=fn: fn(q, k, v, out, lse, g),
                                reps, flush))
                for label, fn in (("other", other_backward),
                                  ("this", ea._eva_attention_backward_cuda),
                                  ("this", ea._eva_attention_backward_cuda),
                                  ("other", other_backward))]
        log(f"backward_ab [{key}] B={b} N={n}: max|x - plain| / scale: "
            f"other {errs['other']:.3g}, this {errs['this']:.3g}; ms: "
            + ", ".join(f"{label} {ms:.4f}" for label, ms in runs))
        del q, k, v, g, out, lse
        torch.cuda.empty_cache()


# the sampling kernel's A/B (``sampling_ab``): (path, table dtype, e4m3
# levels or None)
SAMPLING_AB = (("r50", "bfloat16", None),
               ("vov99 fp8l0", "bfloat16", (True, False, False, False, False)),
               ("r50", "float32", None))


def sampling_ab(other, reps=30):
    """The sampling forward of this checkout against the one of the
    checkout at ``other`` (another commit unpacked with ``git archive``
    into a gitignored directory) on one card, on the seeded inputs of
    ``SAMPLING_AB`` (16-slot rings at the paths' shapes): the two outputs
    bit-equal, then timed in turns (other, this, this, other; CUDA events,
    L2 flushed, median of ``reps`` calls each) (``python3 -c "import
    chip_smoke; chip_smoke.sampling_ab('outputs/parent')"``)."""
    import torch
    sys.path.insert(0, HERE)
    from sparsebev_tpu_torch.ops import msmv_sampling as ms
    dev = torch.device("cuda", 0)
    log(f"sampling_ab [{other}]: {nvidia_smi_line()}")
    libs = dict(other=other_library(other, "msmv_sample"), this=ms._lib())
    fn = libs["other"].msmv_sample_forward
    fn.argtypes = libs["this"].msmv_sample_forward.argtypes
    fn.restype = libs["this"].msmv_sample_forward.restype
    real = ms._lib
    flush = torch.empty(64 * 2**20, dtype=torch.int32, device=dev)
    n, g, cg = SAMPLING_VIEWS, SAMPLING_GROUPS, SAMPLING_CG
    try:
        for pname, dtype, fp8 in SAMPLING_AB:
            path = next(p for p in PATHS if p["name"] == pname)
            gen = torch.Generator(device=dev).manual_seed(4)
            loc, sw, slice_map = _sampling_inputs(torch, dev, path, gen)
            tables = []
            for i, ((h, w), yf) in enumerate(zip(path["levels"],
                                                 path["yfold"])):
                t = torch.randn((SAMPLING_SLOTS * n * h * g, w + 1,
                                 (2 if yf else 1) * cg), generator=gen,
                                device=dev, dtype=getattr(torch, dtype))
                tables.append(t.to(ms.E4M3) if fp8 and fp8[i] else t)
            packed = ms.PackedFeatures(
                tables, path["t"] * g, n, path["levels"], cg, num_groups=g,
                slice_map=slice_map, yfold=path["yfold"],
                gsplit=path["gsplit"])
            outs, runs = {}, []
            for label in ("other", "this", "this", "other"):
                ms._lib = lambda lib=libs[label]: lib
                outs[label] = ms.msmv_sampling(packed, loc, sw)
                runs.append((label, time_ms(
                    torch, lambda: ms.msmv_sampling(packed, loc, sw), reps,
                    flush)))
            same = _bit_equal(torch, outs["this"], outs["other"])
            log(f"sampling_ab [{pname} {dtype}"
                f"{' e4m3 L0' if fp8 else ''}]: outputs bit-equal {same}; "
                "ms: " + ", ".join(f"{label} {t:.4f}" for label, t in runs))
            if not same:
                fail("sampling_ab: the two kernels' outputs differ")
            del tables, packed, outs
            torch.cuda.empty_cache()
    finally:
        ms._lib = real


def step_profile(root=HERE):
    """The r50 training step's device profile for the checkout at ``root``
    (this one by default): builds the training kernels, runs two steps,
    profiles a third with operand shapes recorded and prints the wall and
    device time, device ops, peak memory and the table-gradient chain. To
    compare two checkouts on one card, run it once for each, one process
    each: ``python3 -c "import chip_smoke; chip_smoke.step_profile('DIR')"``.
    """
    import torch
    sys.path.insert(0, os.path.abspath(root))
    from sparsebev_tpu_torch.kernels import build
    dev = torch.device("cuda", 0)
    label = f"step_profile [{root}]"
    log(f"{label}: {nvidia_smi_line()}")
    build.build_all(["msmv_pack", "msmv_pack_pair", "msmv_sample",
                     "msmv_sample_bwd"])
    _, _, _, new_state, run_step, table_numels = _train_harness(torch, dev)
    state = new_state()
    torch.cuda.reset_peak_memory_stats(dev)
    held = torch.cuda.memory_allocated(dev)
    times = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = float(run_step(state)["loss"])
        times.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated(dev) - held
    ops, busy, wall, _, prof = profile_call(
        torch, lambda: run_step(state), record_shapes=True)
    log(f"{label}: ms/step {times[0]:.1f}, {times[1]:.1f} (host clock); "
        f"loss at step 2 {loss:.4f}; peak memory {peak / 2**30:.2f} GiB "
        f"above the weights; one more step under torch.profiler: wall "
        f"{wall:.1f} ms, device busy {busy:.1f} ms, {ops} device ops")
    log_table_gradient_chain(prof, table_numels, label)


# ------------------------------------- chunk-split rings and parallelism --

# the split route of the sampling kernel on seeded tables (phase 3): label,
# the path whose shapes it takes, its e4m3 levels, and the chunks a level.
# The ring holds the path's T slots (a split ring's slot count is the frame
# window), its frames in a permuted slot order, every slot once. No level
# is group-split: a split ring takes none (with y-fold levels the
# group-split flag changes no bit)
SPLIT_CHECKS = (
    ("vov99 fp8l0 split 5", "vov99 fp8l0", (True, False, False, False, False),
     5),
    ("r50 split 2", "r50", (False,) * 4, 2),
)


def _split_view(packed, splits):
    """``packed`` with level l cut into ``splits[l]`` chunks of consecutive
    slots, each chunk a separate tensor (a copy)."""
    tables = []
    for t, sp in zip(packed.tables, splits):
        rows = t.shape[0] // sp
        tables.append(t if sp == 1 else tuple(
            t[i * rows:(i + 1) * rows].clone() for i in range(sp)))
    return packed.replace(tables=tables)


def _split_gate(torch, label, split, unsplit, loc, sw):
    """The split route against the unsplit route over the same values (bit
    for bit: the gate), against its plain version (bit for bit) and against
    itself (two calls bit-equal)."""
    from sparsebev_tpu_torch.ops.msmv_sampling import (msmv_sampling,
                                                       msmv_sampling_plain)
    got = msmv_sampling(split, loc, sw)
    again = msmv_sampling(split, loc, sw)
    want = msmv_sampling(unsplit, loc, sw)
    plain = msmv_sampling_plain(split, loc, sw)
    torch.cuda.synchronize()
    flags = [_bit_equal(torch, got, want), _bit_equal(torch, got, plain),
             _bit_equal(torch, got, again)]
    log(f"sampling split [{label}]: chunks a level {list(split.split)}, "
        f"output {str(got.dtype)[6:]}: bit-equal to the unsplit route "
        f"{flags[0]}, to the plain version {flags[1]}, two calls "
        f"{flags[2]}")
    if not all(flags):
        fail(f"the sampling kernel's split route differs from the unsplit "
             f"route, its plain version or itself ({label})")


def check_sampling_split(torch, dev, flush, bw, fp32_rate):
    """The sampling kernel's chunk-split route (``SPLIT_CHECKS``) on seeded
    tables: held by ``_split_gate``, timed beside its bound (counted as for
    the unsplit call: the same pieces are read) and beside the unsplit call
    on the same values. Returns the numbers by label."""
    from sparsebev_tpu_torch.ops.msmv_sampling import (E4M3, PackedFeatures,
                                                       msmv_sampling)
    out = {}
    for label, pname, fp8, sp in SPLIT_CHECKS:
        path = next(p for p in PATHS if p["name"] == pname)
        gen = torch.Generator(device=dev).manual_seed(9)
        levels, yfold = path["levels"], path["yfold"]
        n, g, cg, t = (SAMPLING_VIEWS, SAMPLING_GROUPS, SAMPLING_CG,
                       path["t"])
        loc, sw, _ = _sampling_inputs(torch, dev, path, gen)
        slot_of_t = torch.randperm(t, generator=gen, device=dev)
        slice_map = (slot_of_t[None, :] * g
                     + torch.arange(g, device=dev)[:, None]).reshape(t * g)
        tables = []
        for (h, w), yf, f8 in zip(levels, yfold, fp8):
            tab = torch.randn((t * n * h * g, w + 1, (2 if yf else 1) * cg),
                              generator=gen, device=dev, dtype=torch.bfloat16)
            tables.append(tab.to(E4M3) if f8 else tab)
            del tab
        unsplit = PackedFeatures(tables, t * g, n, levels, cg, num_groups=g,
                                 slice_map=slice_map, yfold=yfold)
        split = _split_view(unsplit, (sp,) * len(levels))
        _split_gate(torch, label, split, unsplit, loc, sw)
        res = _time_sampling(torch, flush, bw, fp32_rate, split, loc, sw,
                             f"split {label}] split route")
        res["unsplit_ms"] = time_ms(
            torch, lambda: msmv_sampling(unsplit, loc, sw), 30, flush)
        log(f"sampling split [{label}]: the same call over the unsplit ring "
            f"of the same values: {res['unsplit_ms']:.4f} ms against "
            f"{res['ms']:.4f} ms on the split route")
        res["max_abs_err"] = 0.0
        out[label] = res
        del split, unsplit, tables
        torch.cuda.empty_cache()
    return out


def check_split_stream(torch, dev, path, model, det, samples):
    """After a chunk-split stream: the last sample's head over the split
    ring and over the same rows as an unsplit ring (bit-equal end to end),
    and the sampling kernel on that head's first call (``_split_gate``),
    timed beside its bound and the unsplit call. Returns the numbers."""
    from sparsebev_tpu_torch.ops import msmv_sampling as ms
    from sparsebev_tpu_torch.ops import projection
    name = path["name"]
    bw, fp32_rate, _ = peaks(torch.cuda.get_device_name(0))
    cap = {}
    sampling = projection.msmv_sampling

    def record(packed, loc, sw, *a, **k):
        cap.setdefault("call", (packed, loc.clone(), sw.clone()))
        return sampling(packed, loc, sw, *a, **k)

    projection.msmv_sampling = record
    try:
        with torch.inference_mode():
            split_out = replay_head(torch, dev, model, det, det.ring,
                                    samples[-1:])
    finally:
        projection.msmv_sampling = sampling
    unsplit_ring = tuple(_level_tensor(torch, lvl) for lvl in det.ring)
    with torch.inference_mode():
        unsplit_out = replay_head(torch, dev, model, det, unsplit_ring,
                                  samples[-1:])
    same = _output_gap(torch, split_out, unsplit_out)[1]
    chunks = [len(c) if isinstance(c, tuple) else 1 for c in det.ring]
    log(f"streaming [{name}]: the last sample's head over the split ring "
        f"(chunks a level {chunks}) and over its rows as an unsplit ring: "
        f"bit-equal {same}")
    if not same:
        fail(f"the head over the split ring differs from the head over the "
             f"unsplit ring ({name})")
    packed, loc, sw = cap["call"]
    unsplit = packed.replace(tables=[_level_tensor(torch, t)
                                     for t in packed.tables])
    with torch.inference_mode():
        _split_gate(torch, f"{name} recorded", packed, unsplit, loc, sw)
        flush = torch.empty(64 * 2**20, dtype=torch.int32, device=dev)
        res = _time_sampling(torch, flush, bw, fp32_rate, packed, loc, sw,
                             f"{name} recorded points] split route")
        res["unsplit_ms"] = time_ms(
            torch, lambda: ms.msmv_sampling(unsplit, loc, sw), 30, flush)
    log(f"sampling split [{name} recorded]: the unsplit call on the same "
        f"rows {res['unsplit_ms']:.4f} ms against {res['ms']:.4f} ms")
    del flush, unsplit_ring, unsplit, cap
    torch.cuda.empty_cache()
    return dict(res, max_abs_err=0.0)


# the data-parallel step (phase 12): the global batch (one seeded sample a
# rank), the second sample's valid boxes (so that the loss normalizers of
# the two ranks differ and must be summed), and a rank's time limit
DP_SEEDS = (0, 1)
DP_SECOND_SAMPLE_BOXES = 20
RANK_TIMEOUT_S = 300
# the two ranks against the halves reference (``dp_halves``): the same
# arithmetic but for the collectives and the sampling backward's atomic
# adds, whose order alone moved a bf16 backbone gradient of the reference
# 5.4e-3 of its scale between two runs (an NVIDIA H100 80GB HBM3 at 700 W;
# the loss and the head's gradients were bit-equal)
DP_REF_LOSS_RTOL = 1e-5
DP_REF_GRAD_TOL = 2e-2
# the samples of the train CLI's run under torchrun (phase 12)
PARALLEL_TRAIN_SAMPLES = 2
# the query-sharded r50 stream (phase 12): its samples
QSHARD_SAMPLES = 4


def _rank_group(torch, rank, world, workdir):
    """Join a gloo group of ``world`` processes on the one card through a
    FileStore in ``workdir``; returns the card."""
    import datetime
    import torch.distributed as dist
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    dist.init_process_group(
        "gloo", store=dist.FileStore(os.path.join(workdir, "store"), world),
        rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=RANK_TIMEOUT_S))
    return dev


def _run_ranks(entry, world, workdir, label):
    """Start ``world`` processes of this script (``--rank ENTRY r W DIR``)
    on the card and wait for them (at most ``RANK_TIMEOUT_S``); when one
    fails or the time is up, stop the others, print their output and
    fail."""
    import shutil
    shutil.rmtree(workdir, ignore_errors=True)
    os.makedirs(workdir)
    logs = [open(os.path.join(workdir, f"rank{r}.log"), "w+")
            for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--rank", entry, str(r),
         str(world), workdir], stdout=logs[r], stderr=subprocess.STDOUT)
        for r in range(world)]
    deadline = time.monotonic() + RANK_TIMEOUT_S
    try:
        while any(p.poll() is None for p in procs):
            if time.monotonic() > deadline or any(
                    p.poll() not in (None, 0) for p in procs):
                break
            time.sleep(0.5)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    outs = []
    for f in logs:
        f.seek(0)
        outs.append(f.read())
        f.close()
    codes = [p.returncode for p in procs]
    if codes != [0] * world:
        for r, o in enumerate(outs):
            log(f"{label}: rank {r} output (last 3000 bytes):\n{o[-3000:]}")
        fail(f"{label}: the ranks ended with {codes}")


def _dp_config(fp32):
    """The r50 config with the augmentations off (each rank would draw them
    for its own images; dropout is set to 0 in the model): in its own bf16,
    or in fp32 (``fp32``)."""
    from sparsebev_tpu_torch.config import Config
    cfg = Config.fromfile(os.path.join(HERE, PATHS[0]["config"]))
    cfg.model["use_grid_mask"] = False
    cfg.model["data_aug"]["img_color_aug"] = False
    if fp32:
        cfg.model["compute_dtype"] = "float32"
    return cfg


def _summed_normalizer(loss_fn, add):
    """``loss_fn`` with its normalizer's ``reduce`` adding ``add``, what an
    all-reduce over the other rank would add."""
    def call(*args, reduce=None, **kwargs):
        return loss_fn(*args, reduce=lambda t: t + add, **kwargs)
    return call


def dp_step(torch, dev, rank=0, world=1, fp32=False, half=None,
            record=None):
    """One training step of the r50 config at full width on the global
    batch of ``DP_SEEDS`` (seeded weights, dropout 0, augmentations off,
    the denoising noise drawn for the global batch), in bf16 or, with
    ``fp32``, in fp32 with TF32 off for the whole step
    (``utils.device.fp32_precision``). With ``world`` 1: all of it, or
    with ``half`` (0 or 1) that sample alone with its loss normalizers
    summed with the other sample's by hand (no process group: a half of
    :func:`dp_halves`); else this rank's sample with the gradients and the
    loss normalizers summed over the default gloo group. Returns the
    metrics, the probed gradients (before the clip), the launches of the
    step and its host-clock ms. ``record`` (a dict) collects each
    projection call's view choice (``views``: ``[Q, B*G*T, P]`` int8 codes,
    the view plus 6 where the chosen view sees the point), the matcher's
    assignment with its box mask (``assigned``) and the FPN's outputs
    (``neck``, kept on the card) for :func:`choice_probe`."""
    import contextlib
    import numpy as np
    from sparsebev_tpu_torch.losses import draw_dn_noise
    from sparsebev_tpu_torch.models import layers
    from sparsebev_tpu_torch.models.detector import build_detector
    from sparsebev_tpu_torch.parallel import shard_batch
    from sparsebev_tpu_torch.train import optim, step as tstep
    from sparsebev_tpu_torch.utils.device import fp32_precision
    cfg = _dp_config(fp32)
    host = [make_host_batch(cfg, seed) for seed in DP_SEEDS]
    batch = {k: np.concatenate([h[k] for h in host]) for k in host[0]}
    batch["gt_mask"][1, DP_SECOND_SAMPLE_BOXES:] = False
    batch["gt_boxes"][~batch["gt_mask"]] = 0.0
    head = cfg.model["pts_bbox_head"]
    dn_groups = head["query_denoising_groups"]
    noise = draw_dn_noise(torch.Generator().manual_seed(3), len(DP_SEEDS),
                          dn_groups, cfg.max_gt, head["num_classes"], "cpu")
    groups = None
    patched = {}
    if world > 1:
        batch = shard_batch(batch, rank, world)
        noise = shard_batch(noise, rank, world)
        groups = tstep.data_parallel_groups(None)
    elif half is not None:
        # the other sample's valid boxes: what the ranks' all-reduce adds
        # to the detection loss's normalizer and (x groups) the DN loss's
        other = float(batch["gt_mask"][1 - half].sum())
        batch = shard_batch(batch, half, len(DP_SEEDS))
        noise = shard_batch(noise, half, len(DP_SEEDS))
        for name, add in (("compute_detection_loss", other),
                          ("compute_dn_loss", dn_groups * other)):
            patched[name] = _summed_normalizer(getattr(tstep, name), add)
    batch = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
             for k, v in batch.items()}
    noise = {k: v.to(dev) for k, v in noise.items()}
    model = build_detector(cfg, device=dev, seed=0)
    for m in model.modules():
        if isinstance(m, layers.Dropout):
            m.p = 0.0
    opt, sched, _ = optim.optimizer_from_config(model, cfg, total_steps=1000)
    state = tstep.create_train_state(model, opt, sched)
    step = tstep.train_step_from_config(cfg, groups)
    if record is not None:
        record["neck"] = []
        model.img_neck.register_forward_hook(
            lambda mod, args, out: record["neck"].append(
                [o.detach().clone() for o in out]))
        _record_head_modules(torch, model.pts_bbox_head, record)
    grads = {}
    real = dict(clip_by_global_norm=tstep.clip_by_global_norm,
                **{k: getattr(tstep, k) for k in patched})

    def clip(params, max_norm):
        named = dict(model.named_parameters())
        grads.update({k: named[k].grad.detach().to(
                          "cpu", torch.float32, copy=True)
                      for k in TRAIN_GRAD_PROBES})
        return real["clip_by_global_norm"](params, max_norm)

    counters = _counters()
    _reset(counters)
    for k, v in dict(patched, clip_by_global_norm=clip).items():
        setattr(tstep, k, v)
    recorders = _choice_recorders(torch, record) if record is not None \
        else contextlib.nullcontext()
    try:
        with recorders, (fp32_precision() if fp32
                         else contextlib.nullcontext()):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            gen = torch.Generator(device=dev).manual_seed(11)
            _, metrics = step(state, batch, generator=gen,
                              draws={"dn": noise})
            torch.cuda.synchronize()
            ms_step = (time.perf_counter() - t0) * 1e3
    finally:
        for k, v in real.items():
            setattr(tstep, k, v)
    return ({k: float(v) for k, v in metrics.items()}, grads,
            _read(counters), ms_step)


def dp_halves(torch, dev, fp32=False, records=None):
    """The data-parallel step's reference with no parallel code: one
    process runs each sample of the global batch alone through the step
    (:func:`dp_step` with ``half``), its loss normalizers summed with the
    other sample's by hand, and adds the two losses and the two probed
    gradients. Each half is a batch of 1, as on a rank, so its
    convolutions run the ranks' cuDNN algorithms; what is left between it
    and the ranks is the collectives and the sampling backward's atomic
    adds. Returns ``({"loss"}, grads, launches of one half, ms of both)``.
    ``records``: one dict a half for ``dp_step``'s ``record``."""
    parts = [dp_step(torch, dev, fp32=fp32, half=h,
                     record=None if records is None else records[h])
             for h in range(len(DP_SEEDS))]
    loss = sum(p[0]["loss"] for p in parts)
    grads = {k: parts[0][1][k] + parts[1][1][k] for k in TRAIN_GRAD_PROBES}
    return {"loss": loss}, grads, parts[0][2], sum(p[3] for p in parts)


@contextlib.contextmanager
def _choice_recorders(torch, record):
    """Record into ``record`` every ``project_points_qmajor`` call's view
    choice and every matcher call's assignment (``dp_step``)."""
    from sparsebev_tpu_torch.losses import target
    from sparsebev_tpu_torch.ops import projection
    project, match = projection.project_points_qmajor, \
        target.hungarian_matching
    record.update(views=[], assigned=[], neck=[])

    def project_and_record(pts_q, *a, **k):
        loc, valid = project(pts_q, *a, **k)
        n = k.get("num_views", a[3] if len(a) > 3 else 6)
        code = torch.round(loc[..., 2] * (n - 1)) + n * valid
        record["views"].append(code.to(torch.int8).cpu())
        return loc, valid

    def match_and_record(cost, gt_mask):
        out = match(cost, gt_mask)
        record["assigned"].append((out.cpu(), gt_mask.cpu()))
        return out

    projection.project_points_qmajor = project_and_record
    target.hungarian_matching = match_and_record
    try:
        yield
    finally:
        projection.project_points_qmajor = project
        target.hungarian_matching = match


# the head's module calls that the probe records: those of the first
# PROBE_LAYERS decoder layers' forward
PROBE_LAYERS = 2


def _record_head_modules(torch, head, record):
    """Forward hooks on every submodule of ``head`` that keep, in call
    order, each call's first output tensor (detached, on the card) until
    the decoder layer has run ``PROBE_LAYERS`` times (``record["modules"]``:
    ``(name, tensor)``)."""
    record["modules"] = []
    layer = head.transformer.decoder.decoder_layer
    calls = [0]

    def count(mod, args):
        calls[0] += 1

    def keep(name):
        def hook(mod, args, out):
            if calls[0] > PROBE_LAYERS or not torch.is_grad_enabled():
                return
            t = out[0] if isinstance(out, (tuple, list)) else out
            if isinstance(t, torch.Tensor):
                record["modules"].append((name, t.detach().clone()))
        return hook

    layer.register_forward_pre_hook(count)
    for name, mod in head.named_modules():
        if name:
            mod.register_forward_hook(keep(name))


def first_divergence(one, halves):
    """The head's first module call (in call order, over the first
    ``PROBE_LAYERS`` decoder layers) whose output in the batch of 2 differs
    from the halves' (the batch's output split along its batch-major dim:
    the first whose size doubles, the leading one of a batch-major tensor,
    the slice dim of the sampling op's query-major operands); returns
    ``(index, name, shape, difference over scale, calls compared)``, index
    None where none differs."""
    entries = one["modules"]
    n = min(len(entries), *(len(h["modules"]) for h in halves))
    for i in range(n):
        name, both = entries[i]
        for h, half in enumerate(halves):
            hname, got = half["modules"][i]
            dims = [d for d in range(both.dim()) if both.dim() == got.dim()
                    and both.shape[d] == len(halves) * got.shape[d]
                    and both.shape[:d] == got.shape[:d]
                    and both.shape[d + 1:] == got.shape[d + 1:]]
            if hname != name or not (dims or both.shape == got.shape):
                fail(f"probe: module call {i} is {name} {tuple(both.shape)} "
                     f"in the batch of 2 and {hname} {tuple(got.shape)} in "
                     f"half {h}")
            want = both.float()
            if dims:
                per = got.shape[dims[0]]
                want = want.narrow(dims[0], h * per, per)
            d = (got.float() - want).abs().max().item()
            if d > 0:
                scale = max(want.abs().max().item(), 1e-30)
                return i, name, tuple(both.shape), d / scale, n
    return None, None, None, 0.0, n


def choice_probe(one, halves):
    """The discrete choices of the one-process step over the batch of 2
    (``one``, a ``dp_step`` record) against its halves (the records of
    ``dp_halves``), sample by sample: for each projection call, the queries
    whose view choice differs at some point; for each matcher call, the
    ground-truth boxes (of the sample's valid ones) assigned to another
    query in some decoder layer; and the FPN's outputs (the first place the
    step's arithmetic sees the batch size: cuDNN picks its algorithms by
    shape), each level's largest difference over its scale. Returns (per
    call the differing queries of each sample, per matcher call the
    differing boxes of each sample, the valid boxes of each sample, per
    sample each FPN level's difference over its scale)."""
    views, boxes, valid, neck = [], [], [], []
    for h, half in enumerate(halves):
        row = []
        for both, got in zip(one["neck"][0], half["neck"][0]):
            per = both.shape[0] // len(halves)
            want = both[h * per:(h + 1) * per].float()
            scale = max(want.abs().max().item(), 1e-30)
            row.append((got.float() - want).abs().max().item() / scale)
        neck.append(row)
    calls = len(one["views"])
    if any(len(h["views"]) != calls for h in halves):
        fail(f"probe: the batch of 2 made {calls} projection calls, the "
             f"halves {[len(h['views']) for h in halves]}")
    for i in range(calls):
        both = one["views"][i]
        per = both.shape[1] // len(halves)
        views.append([int((both[:, h * per:(h + 1) * per]
                           != halves[h]["views"][i]).flatten(1).any(1).sum())
                      for h in range(len(halves))])
    for i, (both, mask) in enumerate(one["assigned"]):
        row = []
        for h in range(len(halves)):
            got, hmask = halves[h]["assigned"][i]
            m = hmask[0]
            row.append(int((both[:, h][:, m] != got[:, 0][:, m]).any(0)
                           .sum()))
        boxes.append(row)
        valid = [int(mask[h].sum()) for h in range(len(halves))]
    return views, boxes, valid, neck


def log_choice_probe(label, prec, one, halves):
    """Print :func:`choice_probe` of the batch of 2 against its halves."""
    views, boxes, valid, neck = choice_probe(one, halves)
    i, name, shape, share, n = first_divergence(one, halves)
    log(f"{label}: {prec} probe: the head's module calls of the first "
        f"{PROBE_LAYERS} decoder layers, the batch of 2 against its halves: "
        + (f"all {n} bit-equal" if i is None else
           f"the first that differs is call {i} of {n}, {name} "
           f"{shape}, by {share:.3g} of its scale"))
    flipped = [sum(v[h] for v in views) for h in range(len(halves))]
    log(f"{label}: {prec} probe, the batch of 2 against its halves (ROADMAP "
        f"Queue 3 fault 1): FPN outputs, each level's largest difference "
        f"over its scale, per sample "
        f"{[[f'{d:.3g}' for d in row] for row in neck]}; "
        f"projection calls whose view choices differ "
        f"{sum(any(v) for v in views)} of {len(views)} (forward and the "
        f"layer remat's recompute); queries that differ, summed over the "
        f"calls, per sample {flipped}, per call {views}; matcher calls "
        f"whose assignment differs {sum(any(b) for b in boxes)} of "
        f"{len(boxes)}, boxes assigned otherwise in some layer per call "
        f"{boxes} of the valid {valid}")


def _dp_rank(rank, world, workdir):
    """This rank's data-parallel step in bf16, then in fp32 (TF32 off)."""
    import torch
    import torch.distributed as dist
    dev = _rank_group(torch, rank, world, workdir)
    out = {}
    for fp32 in (False, True):
        metrics, grads, launches, ms_step = dp_step(torch, dev, rank, world,
                                                    fp32=fp32)
        torch.cuda.empty_cache()
        out["fp32" if fp32 else "bf16"] = dict(
            metrics=metrics, grads=grads, launches=launches, ms=ms_step)
    torch.save(dict(out, backend=dist.get_backend()),
               os.path.join(workdir, f"rank{rank}.pt"))
    dist.destroy_process_group()


def _record_layers(layer, store):
    """A forward hook on the decoder layer of a query-sharded head that
    gathers each call's query boxes and features and its three outputs over
    the q group into ``store``, with the call's other inputs."""
    def hook(mod, args, kwargs, out):
        q = kwargs["queries"]
        bbox, feat, packed, l2i, td, h, w = args[:7]
        store.append(dict(
            inputs=(q.gather(bbox, 1), q.gather(feat, 1), packed, l2i, td,
                    h, w),
            with_cls=kwargs["with_cls"],
            outputs=[None if o is None else q.gather(o, 1) for o in out]))
    return layer.register_forward_hook(hook, with_kwargs=True)


def _qshard_rank(rank, world, workdir):
    """The r50 config streamed with its head query-sharded over the gloo
    group (every rank on the one card); rank 0 then holds each decoder
    layer of the last sample against the unsharded layer on the same
    (gathered) inputs and streams the same samples unsharded."""
    import torch
    import torch.distributed as dist
    from sparsebev_tpu_torch.config import Config
    from sparsebev_tpu_torch.inference import StreamingDetector
    from sparsebev_tpu_torch.models.detector import build_detector
    from sparsebev_tpu_torch.ops import msmv_pack
    from sparsebev_tpu_torch.ops import msmv_sampling as ms
    from sparsebev_tpu_torch.parallel import QueryShard
    dev = _rank_group(torch, rank, world, workdir)
    cfg = Config.fromfile(os.path.join(HERE, PATHS[0]["config"]))
    head = cfg.model["pts_bbox_head"]
    t = head["num_frames"]
    image_h, image_w = cfg.ida_aug_conf["final_dim"]
    model = build_detector(cfg, device=dev, seed=0)
    stream = make_stream(QSHARD_SAMPLES, t, image_h, image_w)
    det = StreamingDetector(model, num_frames=t, device=dev,
                            query_group=dist.group.WORLD)
    layer = model.pts_bbox_head.transformer.decoder.decoder_layer
    records = []
    counters = dict(pack=msmv_pack.pack_level, sampling=ms.msmv_sampling)
    _reset(counters)
    with torch.inference_mode():
        times, preds = run_stream(torch, det, stream[:-1], prefetch=False)
        handle = _record_layers(layer, records)
        try:
            last_ms, last = run_stream(torch, det, stream[-1:],
                                       prefetch=False)
        finally:
            handle.remove()
    launches = _read(counters)
    shard = QueryShard(det.query_group, head["num_query"])
    result = dict(launches=launches, ms=times[1:] + last_ms,
                  lo_hi=(shard.lo, shard.hi))
    if rank == 0:
        gaps = []
        with torch.inference_mode():
            for rec in records:
                ref = layer(*rec["inputs"], with_cls=rec["with_cls"],
                            deterministic=True)
                gap = 0.0
                for a, b in zip(rec["outputs"], ref):
                    if b is None:
                        continue
                    d = (a.float() - b.float()).abs().max().item()
                    gap = max(gap, d / (STREAM_TOL * max(
                        1.0, b.float().abs().max().item())))
                gaps.append(gap)
            del records
            plain = StreamingDetector(model, num_frames=t, device=dev)
            plain_times, plain_preds = run_stream(torch, plain, stream,
                                                  prefetch=False)
        e2e, exact = _output_gap(torch, preds + last, plain_preds)
        result.update(layer_gaps=gaps, e2e=e2e, e2e_exact=exact,
                      plain_ms=plain_times[1:])
    torch.save(result, os.path.join(workdir, f"rank{rank}.pt"))
    dist.destroy_process_group()


def _train_cli_rank(argv):
    """Under ``torchrun``: the train CLI with ``--multihost`` in this
    process (its launches counted), then one JSON line with what the
    process group and the run were."""
    import torch
    import torch.distributed as dist
    sys.path.insert(0, HERE)
    from sparsebev_tpu_torch.tools import train as train_cli

    class Losses:
        def __init__(self):
            self.losses = []

        def after_iter(self, runner, metrics):
            self.losses.append(metrics["loss"])

    rec = Losses()
    counters = _counters()
    _reset(counters)
    runner = train_cli.main(list(argv) + ["--multihost"], extra_hooks=[rec])
    torch.cuda.synchronize()
    print("TRAIN_CLI_RANK " + json.dumps(dict(
        world=dist.get_world_size(), backend=dist.get_backend(),
        rank=dist.get_rank(), steps=runner.global_step, losses=rec.losses,
        launches=_read(counters))), flush=True)
    dist.destroy_process_group()


def parallel_phase(torch, dev, config):
    """Phase 12: data parallelism and query sharding at r50 full width.

    - the train CLI with ``--multihost`` under ``torchrun`` (one rank,
      NCCL) on ``PARALLEL_TRAIN_SAMPLES`` synthetic samples of 1600x900
      JPEGs (``config``: phase 8's), one epoch of batch 1;
    - the data-parallel step: two ranks in two processes on the one card
      over gloo, one sample each, in bf16 and in fp32 with TF32 off,
      against the halves reference (``dp_halves``): step 1's loss within
      ``DP_REF_LOSS_RTOL`` and the probed gradients within
      ``DP_REF_GRAD_TOL`` of each one's scale; in fp32 also against one
      process over the batch of two (``dp_step``) within
      ``TRAIN_LOSS_RTOL`` / ``TRAIN_GRAD_TOL``;
    - the query-sharded stream: two ranks over gloo, the head's 900
      queries 450 / 450; every decoder layer of the last sample within
      ``STREAM_TOL`` of the unsharded layer on the same inputs; the end to
      end gap to an unsharded stream printed, not held (the seeded head
      amplifies one ulp past the gate, ROADMAP Queue 3 fault 1).

    Returns the launch counts of each run."""
    from sparsebev_tpu_torch.data import make_synthetic_dataset
    launches = {}
    label = "parallel [r50]"
    root = os.path.join(HERE, "outputs", "chip_smoke_parallel")
    # -- the train CLI under torchrun (NCCL, world 1)
    ann = make_synthetic_dataset(
        os.path.join(root, "train"), num_samples=PARALLEL_TRAIN_SAMPLES,
        sweeps_between=DATA_SWEEPS_BETWEEN, image_hw=DATA_IMAGE_HW)
    argv = ["--config", config, "--work-dir",
            os.path.join(root, "torchrun_work"), "--batch-size", "1",
            "--epochs", "1", "--override", f"data.train.ann_file={ann}",
            f"data.train.data_root={os.path.dirname(ann)}",
            "eval_config.interval=0", "checkpoint_config.interval=1"]
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", "1", os.path.abspath(__file__),
           "--train-cli-rank", json.dumps(argv)]
    t0 = time.perf_counter()
    try:
        run = subprocess.run(cmd, capture_output=True, text=True,
                             timeout=RANK_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        fail(f"{label}: torchrun did not finish in {RANK_TIMEOUT_S} s")
    sec = time.perf_counter() - t0
    line = [x for x in run.stdout.splitlines()
            if x.startswith("TRAIN_CLI_RANK ")]
    if run.returncode != 0 or not line:
        log(f"{label}: torchrun output:\n{(run.stdout + run.stderr)[-4000:]}")
        fail(f"{label}: the train CLI under torchrun exited "
             f"{run.returncode}")
    got = json.loads(line[-1].split(" ", 1)[1])
    steps = PARALLEL_TRAIN_SAMPLES
    log(f"{label}: torchrun --standalone --nproc_per_node 1 ... "
        f"sparsebev_tpu_torch.tools.train --multihost: world {got['world']}, "
        f"backend {got['backend']}, {got['steps']} steps in {sec:.1f} s "
        f"(process start, build, loader, steps, checkpoint); loss per step "
        + " ".join(f"{x:.4f}" for x in got["losses"])
        + "; launches " + " ".join(f"{k}={v}" for k, v in
                                   got["launches"].items()))
    if got["world"] != 1 or got["backend"] != "nccl" \
            or got["steps"] != steps \
            or not all(math.isfinite(x) for x in got["losses"]) \
            or min(got["launches"].values()) <= 0:
        fail(f"{label}: the train CLI under torchrun ran {got}")
    launches["r50 torchrun train CLI"] = got["launches"]

    # -- the data-parallel step: two gloo ranks against one process
    t0 = time.perf_counter()
    work = os.path.join(root, "dp")
    _run_ranks("dp", 2, work, f"{label} data-parallel")
    ranks = [torch.load(os.path.join(work, f"rank{r}.pt")) for r in range(2)]
    rank_sec = time.perf_counter() - t0
    log(f"{label}: data-parallel step, 2 ranks x 1 sample over "
        f"{ranks[0]['backend']} on one card, bf16 then fp32 with TF32 off "
        f"({rank_sec:.1f} s with the processes' start)")
    for prec in ("bf16", "fp32"):
        fp32 = prec == "fp32"
        got = [r[prec] for r in ranks]
        two, two_grads = got[0]["metrics"], got[0]["grads"]
        rec_halves, rec_one = [{}, {}], {}
        ref, ref_grads, ref_launches, ref_ms = dp_halves(
            torch, dev, fp32, records=rec_halves)
        one, one_grads, one_launches, one_ms = dp_step(
            torch, dev, fp32=fp32, record=rec_one)
        log_choice_probe(label, prec, rec_one, rec_halves)
        del rec_one, rec_halves
        again = dp_halves(torch, dev, fp32)
        torch.cuda.empty_cache()
        if got[0]["metrics"] != got[1]["metrics"]:
            fail(f"{label}: the two ranks' {prec} metrics differ")
        rel_ref = abs(two["loss"] - ref["loss"]) / abs(ref["loss"])
        rel_one = abs(two["loss"] - one["loss"]) / abs(one["loss"])
        log(f"{label}: {prec}: step {got[0]['ms']:.1f} / {got[1]['ms']:.1f} "
            f"ms a rank; the halves reference (no process group, two "
            f"batches of 1 in one process, normalizers summed by hand) "
            f"{ref_ms:.1f} ms; 1 process x 2 samples {one_ms:.1f} ms; loss "
            f"2 ranks {two['loss']:.6f}, halves {ref['loss']:.6f} "
            f"(relative {rel_ref:.3g}, tolerance {DP_REF_LOSS_RTOL:g}), "
            f"batch of 2 {one['loss']:.6f} (relative {rel_one:.3g}"
            + (f", tolerance {TRAIN_LOSS_RTOL:g})" if fp32 else
               ", printed)"))
        if not rel_ref <= DP_REF_LOSS_RTOL or (
                fp32 and not rel_one <= TRAIN_LOSS_RTOL):
            fail(f"{label}: the {prec} data-parallel step's loss differs")
        for k in TRAIN_GRAD_PROBES:
            a = two_grads[k]
            scale = ref_grads[k].abs().max().item()
            d_ref = (a - ref_grads[k]).abs().max().item() / scale
            d_again = (again[1][k] - ref_grads[k]).abs().max().item() / scale
            d_one = (a - one_grads[k]).abs().max().item() / \
                one_grads[k].abs().max().item()
            d_split = (ref_grads[k] - one_grads[k]).abs().max().item() / \
                one_grads[k].abs().max().item()
            log(f"{label}: {prec} grad {k} (scale {scale:.3g}), max "
                f"difference over the scale: 2 ranks - halves {d_ref:.3g} "
                f"(tolerance {DP_REF_GRAD_TOL:g}); halves - halves again "
                f"{d_again:.3g}; 2 ranks - batch of 2 {d_one:.3g}"
                + (f" (tolerance {TRAIN_GRAD_TOL:g})" if fp32 else
                   " (printed)")
                + f"; halves - batch of 2 {d_split:.3g} (no process group)")
            if not scale > 0 or not d_ref <= DP_REF_GRAD_TOL or (
                    fp32 and not d_one <= TRAIN_GRAD_TOL):
                fail(f"{label}: the {prec} data-parallel gradient of {k} "
                     "differs")
        for r, res in enumerate(got):
            # a step's launches do not depend on the batch size
            if res["launches"] != one_launches \
                    or res["launches"] != ref_launches \
                    or min(res["launches"].values()) <= 0:
                fail(f"{label}: {prec} rank {r} launched {res['launches']}, "
                     f"the one process {one_launches}")
        suffix = "" if fp32 else " bf16"
        for r, res in enumerate(got):
            launches[f"r50 data-parallel{suffix} rank {r}"] = res["launches"]
        launches[f"r50 data-parallel{suffix} one process"] = one_launches

    # -- the query-sharded stream
    t0 = time.perf_counter()
    work = os.path.join(root, "qshard")
    _run_ranks("qshard", 2, work, f"{label} query-sharded")
    ranks = [torch.load(os.path.join(work, f"rank{r}.pt")) for r in range(2)]
    r0 = ranks[0]
    worst = max(r0["layer_gaps"])
    log(f"{label}: query-sharded stream, 2 ranks on one card over gloo, "
        f"queries {[r['lo_hi'] for r in ranks]}, {QSHARD_SAMPLES} samples in "
        f"{time.perf_counter() - t0:.1f} s with the processes' start; "
        f"ms/sample sharded " + " ".join(f"{x:.1f}" for x in r0["ms"])
        + " (two processes share the card: no gain to be had); unsharded "
        + " ".join(f"{x:.1f}" for x in r0["plain_ms"]))
    log(f"{label}: each decoder layer of the last sample against the "
        f"unsharded layer on the same gathered inputs: "
        + " ".join(f"{g:.3g}" for g in r0["layer_gaps"])
        + f" of the tolerance ({STREAM_TOL:g} of each output's scale)")
    log(f"{label}: end to end, sharded vs unsharded stream: worst "
        f"{r0['e2e']:.3g} of the tolerance, bit-equal {r0['e2e_exact']} "
        "(printed, not held: the seeded head amplifies a one-ulp change of "
        "its input past the tolerance; ROADMAP Queue 3 fault 1)")
    layers = _dp_config(False).model["pts_bbox_head"]["num_layers"]
    if len(r0["layer_gaps"]) != layers or not worst <= 1.0:
        fail(f"{label}: a query-sharded decoder layer differs from the "
             f"unsharded layer ({r0['layer_gaps']})")
    for r, res in enumerate(ranks):
        if min(res["launches"].values()) <= 0:
            fail(f"{label}: rank {r} launched {res['launches']}")
        launches[f"r50 query-sharded rank {r}"] = res["launches"]
    return launches


# ------------------------------------------------------------ phase 13 --

# the FPS CLI's runs: samples of its timed loop, its warm-up, the samples
# of its --e2e streams; (label, config, --e2e, --profile-dir) a run (the
# profiled loop runs after the timed one)
TIMING_SAMPLES, TIMING_WARMUP, TIMING_E2E_SAMPLES = 30, 5, 3
TIMING_RUNS = (
    ("r50 400q", "configs/r50_nuimg_704x256_400q_36ep.py", False, False),
    ("r50", "configs/r50_nuimg_704x256.py", True, True),
)
# the JSON keys of the JAX CLI's lines (tools/timing.py), in its order
TIMING_KEYS = dict(
    streaming_fps=["metric", "value", "unit"],
    streaming_fps_e2e=["e2e_fps", "e2e_ms_per_sample", "host_pipeline_ms",
                       "dispatch_upload_forward_ms", "metric"],
    streaming_fps_e2e_overlapped=["e2e_fps", "e2e_ms_per_sample",
                                  "host_wait_ms",
                                  "dispatch_upload_forward_ms", "overlap",
                                  "metric"])


def trace_device_busy(path):
    """Device busy ms (the union of the device events' intervals) and the
    device ops (kernels, copies, memsets) of a ``torch.profiler`` chrome
    trace."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                   if e.get("ph") == "X" and e.get("cat") in (
                       "kernel", "gpu_memcpy", "gpu_memset"))
    busy, end = 0.0, -math.inf
    for a, b in spans:
        if a >= end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    return busy / 1e3, len(spans)


def timing_phase(torch, dev):
    """The port's FPS CLI, ``tools/timing.py::main`` in-process, on the r50
    400-query config and on the r50 config (``--e2e --profile-dir``): its
    JSON lines (JAX's keys, held), the pack and sampling launches of each
    run (held above 0), ms/sample (1000 over the printed FPS), peak memory,
    and from the profiled loop's trace the device busy ms and device ops a
    sample. Returns the launches of each run."""
    from sparsebev_tpu_torch.ops import msmv_pack, msmv_sampling
    from sparsebev_tpu_torch.tools import timing
    root = os.path.join(HERE, "outputs", "chip_smoke_timing")
    counters = dict(pack=msmv_pack.pack_level,
                    sampling=msmv_sampling.msmv_sampling)
    launches = {}
    for label, config, e2e, profiled in TIMING_RUNS:
        argv = ["--config", os.path.join(HERE, config), "--samples",
                str(TIMING_SAMPLES), "--warmup", str(TIMING_WARMUP)]
        extra = ["--e2e", "--e2e-samples", str(TIMING_E2E_SAMPLES)] \
            if e2e else []
        trace = os.path.join(root, label.replace(" ", "_")) if profiled \
            else None
        if trace is not None:
            extra += ["--profile-dir", trace]
        held = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        for c in counters.values():
            c.launches = 0
        t0 = time.perf_counter()
        lines = timing.main(argv + extra)
        sec = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated(dev) - held
        got = {k: c.launches for k, c in counters.items()}
        want = ["streaming_fps"] + (
            ["streaming_fps_e2e", "streaming_fps_e2e_overlapped"]
            if "--e2e" in extra else [])
        if [ln.get("metric") for ln in lines] != want or any(
                list(ln) != TIMING_KEYS[ln["metric"]] for ln in lines):
            fail(f"timing [{label}]: the CLI printed {lines}")
        fps = lines[0]["value"]
        if not (math.isfinite(fps) and fps > 0) or min(got.values()) <= 0:
            fail(f"timing [{label}]: {fps} FPS, launches {got}")
        for ln in lines:
            log(f"timing [{label}]: {json.dumps(ln)}")
        log(f"timing [{label}]: {1e3 / fps:.3f} ms/sample (1000 / the "
            f"printed FPS; make_ring_bench, {TIMING_SAMPLES} samples after "
            f"{TIMING_WARMUP})")
        log(f"timing [{label}]: peak memory {peak / 2**30:.2f} GiB (above "
            f"{held / 2**30:.2f} GiB held by earlier phases)")
        log(f"timing [{label}]: launches " + " ".join(
            f"{k}={v}" for k, v in got.items()) + f"; {sec:.1f} s in main")
        if trace is not None:
            busy, ops = trace_device_busy(os.path.join(trace, "trace.json"))
            log(f"timing [{label}]: device busy {busy / TIMING_SAMPLES:.3f} "
                f"ms a sample, {ops / TIMING_SAMPLES:.1f} device ops a "
                f"sample (the profiled loop's trace, {ops} ops in "
                f"{busy:.1f} ms)")
            if ops <= 0:
                fail(f"timing [{label}]: the trace holds no device op")
        launches[f"timing {label}"] = got
        torch.cuda.empty_cache()
    return launches


# the dumps of one sample (phase 13), with their shapes given (Q, T, G * P,
# classes), the attention's 8 heads and the decoded boxes' 9 values
DUMP_SHAPES = dict(sasa_tau=lambda q, t, gp, k: (1, q, 8),
                   sample_points_cam=lambda q, t, gp, k: (1, t, q, gp, 3),
                   sample_points_cam_valid_mask=lambda q, t, gp, k:
                   (1, t, q, gp),
                   query_bbox=lambda q, t, gp, k: (1, q, 9),
                   bbox_pred=lambda q, t, gp, k: (1, q, 9),
                   cls_score=lambda q, t, gp, k: (1, q, k))


def dumps_phase(torch, dev):
    """One r50 sample at full width through a ``StreamingDetector`` with
    the decoder's ``DUMP`` off, then through a fresh one with it on: every
    stage's files (their names, shapes and finite values), the dumped
    class scores equal to the sigmoid of the returned ones, and the boxes
    of every layer, the last layer's scores and the decoded boxes bit-equal
    to the run with dumps off. Returns the launches of the dumped run."""
    import shutil
    import numpy as np
    from sparsebev_tpu_torch.bbox.nms_free_coder import build_coder
    from sparsebev_tpu_torch.config import Config
    from sparsebev_tpu_torch.inference import StreamingDetector
    from sparsebev_tpu_torch.models.detector import build_detector
    from sparsebev_tpu_torch.ops import msmv_pack, msmv_sampling
    from sparsebev_tpu_torch.utils.dump import DUMP
    label = "dumps [r50]"
    cfg = Config.fromfile(os.path.join(HERE, PATHS[0]["config"]))
    image_h, image_w = cfg.ida_aug_conf["final_dim"]
    model = build_detector(cfg, device=dev, seed=0)
    head = model.pts_bbox_head
    decoder = head.transformer.decoder
    t, q, layers = head.num_frames, head.num_query, decoder.num_layers
    gp = head.num_groups * decoder.decoder_layer.sampling.num_points
    coder = build_coder(cfg)
    sample = make_stream(1, t, image_h, image_w)[0]
    out_dir = os.path.join(HERE, "outputs", "chip_smoke_dumps")
    shutil.rmtree(out_dir, ignore_errors=True)
    counters = dict(pack=msmv_pack.pack_level,
                    sampling=msmv_sampling.msmv_sampling)
    runs = {}
    with torch.inference_mode():
        for dump in (False, True):
            det = StreamingDetector(model, num_frames=t, device=dev)
            for c in counters.values():
                c.launches = 0
            if dump:
                DUMP.enable(out_dir)
            try:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = det.infer(*sample)
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) * 1e3
            finally:
                DUMP.enabled = False
            runs[dump] = (out, ms, {k: c.launches for k, c in
                                    counters.items()},
                          coder.decode(out))
            del det
    (off, off_ms, _, off_dec), (on, on_ms, on_launches, on_dec) = \
        runs[False], runs[True]
    names = sorted(f"{n}_stage{i}.npy" for n in DUMP_SHAPES
                   for i in range(layers))
    if sorted(os.listdir(out_dir)) != names:
        fail(f"{label}: the dumps are {sorted(os.listdir(out_dir))}")
    for i in range(layers):
        for n, shape in DUMP_SHAPES.items():
            a = np.load(os.path.join(out_dir, f"{n}_stage{i}.npy"))
            want = shape(q, t, gp, head.num_classes)
            if a.shape != want or a.dtype != np.float32 \
                    or not np.isfinite(a).all():
                fail(f"{label}: {n} stage {i}: {a.shape} {a.dtype}, want "
                     f"{want} float32, finite")
        dumped = np.load(os.path.join(out_dir, f"cls_score_stage{i}.npy"))
        if not np.array_equal(dumped, torch.sigmoid(
                on["all_cls_scores"][i]).float().cpu().numpy()):
            fail(f"{label}: stage {i}'s dumped scores are not the sigmoid "
                 "of its returned scores")
    valid = np.load(os.path.join(out_dir,
                                 f"sample_points_cam_valid_mask_stage"
                                 f"{layers - 1}.npy"))
    exact = (torch.equal(on["all_bbox_preds"], off["all_bbox_preds"])
             and torch.equal(on["all_cls_scores"][-1],
                             off["all_cls_scores"][-1])
             and all(torch.equal(on_dec[k], off_dec[k]) for k in off_dec))
    size = sum(os.path.getsize(os.path.join(out_dir, f)) for f in names)
    log(f"{label}: {len(names)} files ({len(DUMP_SHAPES)} names x {layers} "
        f"stages, {size / 1e6:.1f} MB) under {os.path.relpath(out_dir, HERE)}"
        f", shapes as given, finite; the last stage's points in a view "
        f"{valid.mean():.3f}; the sample {off_ms:.1f} ms with dumps off, "
        f"{on_ms:.1f} ms with them on (host copies); launches "
        + " ".join(f"{k}={v}" for k, v in on_launches.items())
        + f"; the boxes of every layer, the last layer's scores and the "
        f"decoded boxes bit-equal to the run with dumps off: {exact}")
    if not exact or min(on_launches.values()) <= 0:
        fail(f"{label}: dumps changed a prediction, or a kernel was not "
             "launched")
    del model
    torch.cuda.empty_cache()
    return on_launches


DW_SPEC = "V-19-dw-eSE"
DW_REPS = 3


def depthwise_phase(torch, dev):
    """The vov99 config's detector on the depthwise spec ``DW_SPEC`` at
    1600x640 (seeded weights): ``forward_frame_packed`` of one frame of six
    views with the kernels (the packs' launches held above 0), timed on the
    host clock, then with the plain versions: every level's table bit-equal
    (held within ``STREAM_TOL`` of its scale). Returns the launches of one
    frame pass."""
    from sparsebev_tpu_torch.config import Config
    from sparsebev_tpu_torch.models.detector import build_detector
    from sparsebev_tpu_torch.ops import msmv_pack
    label = f"depthwise [{DW_SPEC}]"
    vov = PATHS[1]
    cfg = Config.fromfile(os.path.join(HERE, vov["config"]))
    cfg.model["img_backbone"]["spec_name"] = DW_SPEC
    image_h, image_w = cfg.ida_aug_conf["final_dim"]
    held = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    model = build_detector(cfg, device=dev, seed=0)
    frame = torch.from_numpy(make_stream(1, 1, image_h, image_w)[0][0]).to(
        dev)
    counters = dict(pack=msmv_pack.pack_level,
                    pack_pair=msmv_pack.pack_level_pair)
    with torch.inference_mode():
        for c in counters.values():
            c.launches = 0
        fp = model.forward_frame_packed(frame)
        got = {k: c.launches for k, c in counters.items()}
        times = []
        for _ in range(DW_REPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model.forward_frame_packed(frame)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        with plain_versions():
            plain = model.forward_frame_packed(frame)
    peak = torch.cuda.max_memory_allocated(dev) - held
    exact, worst = True, 0.0
    for a, b in zip(fp.tables, plain.tables):
        d = (a.float() - b.float()).abs().max().item()
        worst = max(worst, d / max(1.0, b.float().abs().max().item()))
        exact = exact and _bit_equal(torch, a, b)
    n_params = sum(p.numel() for p in model.img_backbone.parameters())
    log(f"{label}: the vov99 config's detector on {DW_SPEC} "
        f"({n_params / 1e6:.2f}M backbone parameters), one frame of 6 views "
        f"at {image_w}x{image_h}: tables "
        + " ".join(str(tuple(t.shape)) for t in fp.tables)
        + f" ({''.join('y' if yf else 'p' for yf in fp.yfold)}); launches "
        + " ".join(f"{k}={v}" for k, v in got.items())
        + f"; frame pass {statistics.median(times):.3f} ms (median of "
        f"{DW_REPS}, host clock, synchronized); peak memory "
        f"{peak / 2**30:.2f} GiB; against the plain versions: worst "
        f"{worst:.3g} of each level's scale, bit-equal {exact}")
    if min(got.values()) <= 0 or not worst <= STREAM_TOL:
        fail(f"{label}: the frame pass launched {got}, or differs from the "
             "plain versions")
    del model, fp, plain
    torch.cuda.empty_cache()
    return got


LOADER_BENCH_REPS = 2


def side_tools_phase(torch):
    """The port's loader bench (8 frames of 6 JPEGs of 1600x900,
    ``LOADER_BENCH_REPS`` reps; PIL where the native decoder does not
    load) and the parity dry run on the r50 config with its val split
    keeping the ground truth (``val_with_gt_config``; ``--synthetic --limit
    2``: the val CLI in a subprocess on the card), their JSON printed; an
    NDS must come back, with no gate on its value: the weights are
    seeded."""
    import shutil
    from sparsebev_tpu_torch.tools import loader_bench, parity
    rows = loader_bench.main(["--frames", "8", "--reps",
                              str(LOADER_BENCH_REPS)])
    if not rows or any(not r["samples_per_s"] > 0 for r in rows):
        fail(f"loader bench: {rows}")
    for r in rows:
        log(f"loader bench: {json.dumps(r)}")
    work = os.path.join(HERE, "outputs", "chip_smoke_parity")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    t0 = time.perf_counter()
    rc = parity.main(["--config", val_with_gt_config(work), "--synthetic",
                      "--limit", "2", "--work-dir", work])
    sec = time.perf_counter() - t0
    if rc != 0:
        fail(f"parity dry run: exit code {rc}")
    with open(os.path.join(work, "parity.json")) as f:
        report = json.load(f)
    log(f"parity [r50]: parity.json keys {list(report)}: "
        f"{json.dumps(report)} ({sec:.1f} s, the val CLI's process "
        "included; no NDS gate: seeded weights)")
    if list(report) != ["nds", "expected", "checkpoint", "work_dir"] \
            or report["nds"] is None:
        fail(f"parity dry run: {report}")


def side_phases(torch, dev, launches):
    """Phase 13: the FPS CLI, the dumps, the depthwise frame pass and the
    side tools, each timed; their launches go into ``launches``."""
    t0 = time.perf_counter()
    launches.update(timing_phase(torch, dev))
    log(f"phase: the FPS CLI (r50 400q, r50 with --e2e and --profile-dir) "
        f"took "
        f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    launches["r50 dumps"] = dumps_phase(torch, dev)
    log(f"phase: dumps (r50, one sample) took "
        f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    launches["vov99 depthwise frame"] = depthwise_phase(torch, dev)
    log(f"phase: depthwise frame pass ({DW_SPEC}, 1600x640) took "
        f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    side_tools_phase(torch)
    log(f"phase: loader bench and parity dry run took "
        f"{time.perf_counter() - t0:.1f} s")


KERNELS = dict(
    pack=dict(name="msmv_pack_level", route="cuda",
              source="sparsebev_tpu_torch/csrc/msmv_pack.cu",
              replaces="sparsebev_tpu/ops/msmv_pack_pallas.py:63"),
    pack_pair=dict(name="msmv_pack_pair_level", route="cuda",
                   source="sparsebev_tpu_torch/csrc/msmv_pack_pair.cu",
                   replaces="sparsebev_tpu/ops/msmv_pack_pallas.py:154"),
    sampling=dict(name="msmv_sample_forward", route="cuda",
                  source="sparsebev_tpu_torch/csrc/msmv_sample.cu",
                  replaces="sparsebev_tpu/ops/msmv_sampling.py:1011"),
    # the same kernel's launches that read an e4m3 level (fp8 rings), and
    # its numbers on that route (check_sampling_e4m3)
    sampling_e4m3=dict(name="msmv_sample_forward (e4m3 levels beside bf16)",
                       route="cuda",
                       source="sparsebev_tpu_torch/csrc/msmv_sample.cu",
                       replaces="sparsebev_tpu/ops/msmv_sampling.py:1011"),
    # the same kernel's launches that read an e4m3 level beside fp32 ones
    # (an fp32 model's fp8 ring), and its numbers on that route
    sampling_e4m3_fp32=dict(
        name="msmv_sample_forward (e4m3 levels beside fp32)", route="cuda",
        source="sparsebev_tpu_torch/csrc/msmv_sample.cu",
        replaces="sparsebev_tpu/ops/msmv_sampling.py:1011"),
    # the same kernel's launches over a chunk-split ring (table_split),
    # and its numbers on that route (check_sampling_split, the r50 split
    # stream's recorded call)
    sampling_split=dict(name="msmv_sample_forward (chunk-split levels)",
                        route="cuda",
                        source="sparsebev_tpu_torch/csrc/msmv_sample.cu",
                        replaces="sparsebev_tpu/ops/msmv_sampling.py:1011"),
    onehot=dict(name="msmv_onehot_sample_level", route="cuda",
                source="sparsebev_tpu_torch/csrc/msmv_onehot.cu",
                replaces="sparsebev_tpu/ops/msmv_pallas.py:89"),
    onehot_fused=dict(name="msmv_onehot_sample_levels", route="cuda",
                      source="sparsebev_tpu_torch/csrc/msmv_onehot.cu",
                      replaces="sparsebev_tpu/ops/msmv_pallas.py:89"),
    mixing=dict(name="mixing_core_twopass", route="cuda",
                source="sparsebev_tpu_torch/csrc/mixing.cu",
                replaces="sparsebev_tpu/ops/mixing_pallas.py:74"),
    mixing_batched=dict(name="mixing_core_onepass", route="cuda",
                        source="sparsebev_tpu_torch/csrc/mixing.cu",
                        replaces="sparsebev_tpu/ops/mixing_pallas.py:160"),
    attention=dict(name="eva_attention", route="cuda",
                   source="sparsebev_tpu_torch/csrc/eva_attention.cu",
                   replaces="sparsebev_tpu/models/eva02.py:175"),
    # jax.grad of the same call (XLA autodiff; no custom VJP in JAX)
    attention_bwd=dict(name="eva_attention_backward", route="cuda",
                       source="sparsebev_tpu_torch/csrc/eva_attention.cu",
                       replaces="sparsebev_tpu/models/eva02.py:175"),
    # the trunk's Linear layers (XLA dots; no Pallas kernel)
    linear=dict(name="eva_linear", route="cuda",
                source="sparsebev_tpu_torch/csrc/eva_linear.cu",
                replaces="sparsebev_tpu/models/eva02.py:144"),
    tap_fold=dict(name="tap_fold_epilogue", route="cuda",
                  source="sparsebev_tpu_torch/csrc/tap_fold.cu",
                  replaces="sparsebev_tpu/ops/msmv_epilogue_pallas.py:73"),
    sampling_bwd=dict(name="msmv_sample_backward", route="cuda",
                      source="sparsebev_tpu_torch/csrc/msmv_sample_bwd.cu",
                      replaces="sparsebev_tpu/ops/msmv_sampling.py:857"),
    pack_bwd=dict(name="msmv_pack_level_bwd", route="cuda",
                  source="sparsebev_tpu_torch/csrc/msmv_pack.cu",
                  replaces="sparsebev_tpu/ops/msmv_pack_pallas.py:125"),
    pack_pair_bwd=dict(name="msmv_pack_pair_level_bwd", route="cuda",
                       source="sparsebev_tpu_torch/csrc/msmv_pack_pair.cu",
                       replaces="sparsebev_tpu/ops/msmv_pack_pallas.py:214"),
)
_CHECKS = dict(pack=check_pack, pack_pair=check_pack_pair,
               sampling=check_sampling, attention=check_attention)


def kernels_line(measured, launches):
    """The ``{"kernels": [...]}`` object: per kernel its launches summed
    over the runs that drive it (streaming paths, the hybrid path, the
    op-level runs; per run under ``launches_by_path``), and its numbers.
    The headline numbers are those of the first path that measured the
    kernel (r50 where it runs there); every path's are under ``by_path``.
    The mixing rows add ``chain_ms``, the decoder's own chain on the same
    inputs (a yardstick, not a library call), the achieved ``gbytes_per_s``
    and ``bound_share`` (bound over time), and the same for fp32 inputs
    under ``fp32_*``. The fused one-hot row adds ``per_level_ms``, the
    per-level kernel's launches for the same levels, and its time and bound
    with an fp32 accumulator under ``fp32_acc_*``."""
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    rows = []
    for k, info in KERNELS.items():
        by_path = measured[k]
        head = by_path[next(iter(by_path))]
        extra = {key: v for key, v in head.items()
                 if key not in keys and key != "max_abs_err"}
        rows.append(dict(
            info,
            launches=sum(run.get(k, 0) for run in launches.values()),
            max_abs_err=max(m["max_abs_err"] for m in by_path.values()),
            **{key: head[key] for key in keys}, **extra,
            launches_by_path={p: run[k] for p, run in launches.items()
                              if k in run},
            by_path={p: {key: v for key, v in m.items()
                         if key != "max_abs_err"}
                     for p, m in by_path.items()}))
    return {"kernels": rows}


def main() -> int:
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    sys.path.insert(0, HERE)
    try:
        import sparsebev_tpu_torch  # noqa: F401
        from sparsebev_tpu_torch.kernels import build
    except ImportError as e:
        fail(f"the sparsebev_tpu_torch package is not beside this script "
             f"({e})")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a "
             "CUDA card")
    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    try:
        import triton  # noqa: F401
        triton_ok = f"yes ({triton.__version__})"
    except Exception as e:  # noqa: BLE001 - report whatever import raised
        triton_ok = f"no ({type(e).__name__})"
    try:
        nvcc = build.find_nvcc()
        ver = subprocess.run([nvcc, "--version"], capture_output=True,
                             text=True, timeout=60).stdout.strip()
        nvcc_msg = f"{nvcc} ({ver.splitlines()[-1] if ver else '?'})"
    except RuntimeError as e:
        fail(str(e))
    visible = torch.cuda.device_count()
    log(f"env: {smi}; torch {torch.__version__} CUDA {torch.version.cuda}; "
        f"nvcc {nvcc_msg}; import triton: {triton_ok}")
    log(f"env: {visible} card(s) visible; this run uses cuda:0 alone")
    log("env: JPEG decoders on this host: " + jpeg_decoders(
        os.path.dirname(os.path.dirname(os.path.realpath(nvcc)))))
    bw, fp32_rate, bf16_rate = peaks(name)
    log(f"env: bound rates for {name}: {bw / 1e12:.2f} TB/s, "
        f"{fp32_rate / 1e12:.0f} TFLOP/s fp32, {bf16_rate / 1e12:.0f} "
        "TFLOP/s bf16 tensor cores")

    t0 = time.perf_counter()
    sources = ["msmv_pack", "msmv_pack_pair", "msmv_sample",
               "msmv_sample_bwd", "msmv_onehot", "mixing", "tap_fold",
               "eva_attention", "eva_linear"]
    try:
        logs = build.build_all(sources)
    except RuntimeError as e:
        fail(str(e))
    log(f"build: nvcc {' '.join(build.NVCC_FLAGS)}: {len(sources)} sources "
        f"built in {time.perf_counter() - t0:.1f} s")
    attention_sass(build.library_path("eva_attention"))
    for src, text in logs.items():
        if src == "eva_attention":
            attention_ptxas(text)
            continue
        if src == "eva_linear":
            linear_ptxas(text, build.library_path("eva_linear"))
            continue
        if src in PTXAS_REPORTS:
            for r in ptxas_report(text):
                log(f"ptxas[{src}]: {r['kernel']}: {r['regs']} registers, "
                    f"{r['smem']} bytes static shared memory, {r['stack']} "
                    f"bytes stack frame, spills {r['spill_stores']} / "
                    f"{r['spill_loads']} bytes (stores / loads)")
            continue
        for line in text.splitlines():
            if any(w in line for w in ("Used", "spill", "error", "warning")):
                log(f"build[{src}]: {line.strip()}")

    torch.backends.cudnn.benchmark = False
    t0 = time.perf_counter()
    flush = torch.empty(64 * 2**20, dtype=torch.int32, device=dev)  # 256 MB
    measured = {k: {} for k in KERNELS}
    for path in PATHS:
        for k in path.get("checks", path["kernels"]):
            args = (fp32_rate,) if k in ("sampling", "attention") else ()
            res = _CHECKS[k](torch, dev, flush, bw, *args, path)
            if k == "attention":        # one result per shape
                measured[k].update(res)
            else:
                measured[k][path["name"]] = res
    for label, res in check_sampling_e4m3(torch, dev, flush, bw,
                                          fp32_rate).items():
        key = ("sampling_e4m3" if res.pop("base") == "bfloat16"
               else "sampling_e4m3_fp32")
        measured[key][label] = res
    measured["sampling_split"].update(check_sampling_split(
        torch, dev, flush, bw, fp32_rate))
    measured["linear"].update(check_linear(torch, dev, flush, bw, fp32_rate))
    del flush
    torch.cuda.empty_cache()
    check_fp32_conv(torch, dev)
    log(f"phase: kernel checks took {time.perf_counter() - t0:.1f} s")

    launches, captured = {}, {}
    for path in PATHS:
        t0 = time.perf_counter()
        launches[path["name"]], _, captured[path["name"]] = streaming_phase(
            torch, dev, path)
        log(f"phase: streaming [{path['name']}] took "
            f"{time.perf_counter() - t0:.1f} s")
        if "split" in captured[path["name"]]:
            measured["sampling_split"][f"{path['name']} recorded"] = \
                captured[path["name"]].pop("split")
    t0 = time.perf_counter()
    fp8_drift_phase(torch)
    log(f"phase: fp8 drift (vov99, {FP8_DRIFT_SAMPLES} samples, two "
        f"streams) took {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    flush = torch.empty(64 * 2**20, dtype=torch.int32, device=dev)
    source = next(p["name"] for p in PATHS if p.get("hybrid_source"))
    with torch.inference_mode():
        (launches["hybrid"], launches[f"onehot {source} levels"],
         measured["onehot"][f"{source} levels"],
         measured["onehot_fused"]["hybrid"]) = hybrid_phase(
             torch, flush, bw, captured[source])
    log(f"phase: hybrid path took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    with torch.inference_mode():
        measured["sampling"][f"{source} recorded"] = check_sampling_recorded(
            torch, flush, bw, fp32_rate, captured[source], source)
        for path in PATHS:
            pname = path["name"]
            if "mixing" not in captured[pname]:
                continue
            launches[f"mixing {pname}"], res = check_mixing(
                torch, flush, bw, fp32_rate, bf16_rate, pname,
                captured[pname].pop("mixing"))
            for key, m in res.items():
                measured[key][pname] = m
        launches["mixing other shapes"], res = check_mixing_shapes(torch, dev)
        for key, m in res.items():
            measured[key]["other shapes"] = m
        launches[f"tap_fold {source}"], measured["tap_fold"][source] = \
            check_tap_fold(torch, flush, bw, fp32_rate, captured[source])
    del captured
    torch.cuda.empty_cache()
    log(f"phase: recorded-points sampling, mixing and tap fold checks took "
        f"{time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    (launches["r50 train"], measured["sampling_bwd"]["r50 train recorded"],
     _) = training_phase(torch, dev, flush, bw, fp32_rate,
                         compare_remat=True)
    # (no inference_mode here: the plain backward is autograd)
    check_reduction_rounding(torch, dev)
    measured["sampling_bwd"]["r50 train uniform"] = check_sampling_backward(
        torch, flush, bw, fp32_rate,
        *synthetic_train_sampling(torch, dev, torch.bfloat16),
        "r50 train, uniform points")
    check_sampling_backward(
        torch, flush, bw, fp32_rate,
        *synthetic_train_sampling(torch, dev, torch.float32),
        "r50 train, uniform points", timed=False)
    measured["pack_bwd"]["r50 train"] = check_pack_bwd(torch, dev, flush, bw)
    _, measured["pack_pair_bwd"]["vov99 L0"] = check_pack_pair_bwd(
        torch, dev, flush, bw)
    torch.cuda.empty_cache()
    log(f"phase: training (r50, {TRAIN_STEPS} steps, the plain step and the "
        f"three training kernels' checks) took "
        f"{time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    launches["r50 train loop"], loop_figures = runner_phase(torch, dev)
    log(f"phase: training loop (r50, {RUNNER_EPOCHS} epochs, resume, one "
        f"more epoch) took {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    data_launches, data_figures = data_path_phase(
        torch, dev, loop_figures["ms_per_step"])
    launches.update(data_launches)
    log(f"phase: data path and CLIs (r50, {DATA_EPOCHS} epochs from JPEGs, "
        f"the EvalHook, val offline and online) took "
        f"{time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    vov = PATHS[1]
    (launches["vov99 train"],
     measured["sampling_bwd"]["vov99 train recorded"], _) = training_phase(
         torch, dev, flush, bw, fp32_rate, vov, VOV_TRAIN_GRAD_PROBES)
    # the pair adjoint at the step's shape: T * 6 images of level 0
    (h0, w0), = [hw for hw, yf in zip(vov["levels"], vov["yfold"]) if not yf]
    _, pair_train = check_pack_pair_bwd(
        torch, dev, flush, bw, shape=(vov["t"] * 6, h0, w0),
        label="vov99 train")
    measured["pack_pair_bwd"] = {"vov99 train": pair_train,
                                 **measured["pack_pair_bwd"]}
    torch.cuda.empty_cache()
    log(f"phase: training (vov99, {TRAIN_STEPS} steps, the plain step, the "
        f"recorded sampling backward and the pair adjoint) took "
        f"{time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    launches["r101 train"] = r101_training(torch, dev, flush, bw, fp32_rate,
                                           measured)
    torch.cuda.empty_cache()
    log(f"phase: training (r101, {TRAIN_STEPS} steps, the plain step, the "
        f"recorded sampling backward and the pack adjoint at 5 levels) took "
        f"{time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    launches["eva02 train"] = eva02_training(torch, dev, flush, bw,
                                             fp32_rate, measured)
    del flush
    torch.cuda.empty_cache()
    log(f"phase: training (eva02, the attention backward's checks, the "
        f"trunk gate, {EVA_TRAIN_STEPS} steps, the plain step and the probe) "
        f"took {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    launches.update(parallel_phase(torch, dev, data_figures["config"]))
    torch.cuda.empty_cache()
    log(f"phase: parallelism (r50: the train CLI under torchrun, the "
        f"data-parallel step on two gloo ranks, the query-sharded stream on "
        f"two gloo ranks) took {time.perf_counter() - t0:.1f} s")

    side_phases(torch, dev, launches)

    log(json.dumps(kernels_line(measured, launches)))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": 1}}))
    return 0


def rank_main(argv) -> int:
    """The processes that phase 12 starts: ``--rank dp|qshard RANK WORLD
    DIR`` (a gloo rank on the card) and ``--train-cli-rank ARGV_JSON``
    (the train CLI under torchrun)."""
    sys.path.insert(0, HERE)
    if argv[0] == "--train-cli-rank":
        _train_cli_rank(json.loads(argv[1]))
        return 0
    entry, rank, world, workdir = argv[1], int(argv[2]), int(argv[3]), argv[4]
    dict(dp=_dp_rank, qshard=_qshard_rank)[entry](rank, world, workdir)
    return 0


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] in ("--rank", "--train-cli-rank"):
        sys.exit(rank_main(sys.argv[1:]))
    sys.exit(main())
