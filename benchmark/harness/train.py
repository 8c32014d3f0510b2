"""The ``train`` driver: the port's training step at its published batch.

Set-up builds one training state (the detector with seeded weights, AdamW
with the config's groups and schedule) and the step of
``train_step_from_config``, makes the traffic's pool of host batches, and
drives that state through its first three steps, each on another batch
through the window's own call and feed (``Runner.upload``, then the step
with the run's generator). Those steps give the readings the reference
follows: each step's loss, each leaf's gradient as AdamW got it at step 1
(read back from its first moment), and each leaf's change after the three.
The window then runs further steps on the same state until ``--seconds``
have passed and ends synchronized. With the port freed, the reference
builds the same state from the same seed and takes the same three steps.
"""

from __future__ import annotations

import copy
import gc
import time
import types

import numpy as np

from . import check, flops, trace, traffic
from .common import log
from .weights import build_on_device

FOLLOWED_STEPS = 3


def _leaf_norms(torch, tensors) -> np.ndarray:
    if not tensors:
        return np.zeros(0)
    return np.asarray([float(x) for x in torch._foreach_norm(
        [t.float() for t in tensors])], np.float64)


def _adam_grad_norms(torch, optimizer, params) -> np.ndarray:
    """Each leaf's gradient as AdamW took it at its first step: the first
    moment over ``1 - beta1`` (zero for a leaf without state)."""
    out = []
    for group in optimizer.param_groups:
        beta1 = group["betas"][0]
        for p in group["params"]:
            st = optimizer.state.get(p)
            out.append(None if not st else st["exp_avg"] / (1.0 - beta1))
    norms = iter(_leaf_norms(torch, [g for g in out if g is not None]))
    return np.asarray([0.0 if g is None else next(norms) for g in out])


def _params(optimizer):
    return [p for g in optimizer.param_groups for p in g["params"]]


SMALL_LEAF = 4096  # elements: the leaves whose element readings are logged


def _small(torch, tensors) -> list:
    """Each tensor of at most :data:`SMALL_LEAF` elements flattened on the
    host in one transfer (None for a larger one or a missing one)."""
    picked = [t for t in tensors if t is not None and t.numel() <= SMALL_LEAF]
    if not picked:
        return [None] * len(tensors)
    flat = iter(torch.cat([t.detach().float().flatten() for t in picked])
                .cpu().split([t.numel() for t in picked]))
    return [next(flat).numpy().astype(np.float64)
            if t is not None and t.numel() <= SMALL_LEAF else None
            for t in tensors]


def _first_moments(optimizer):
    return [(optimizer.state.get(p) or {}).get("exp_avg")
            for p in _params(optimizer)]


def _followed(torch, state, step, feed, pool, gen, optimizer):
    """The first three steps and their readings; for each small leaf also
    its elements' gradients at each step (from AdamW's first moment) and
    their changes, which are logged and not compared."""
    params = _params(optimizer)
    beta1 = np.asarray([g["betas"][0] for g in optimizer.param_groups
                        for _ in g["params"]])
    names = {id(p): n for n, p in state.model.named_parameters()}
    p0 = [p.detach().to("cpu", copy=True) for p in params]
    losses, grad, moments = [], None, []
    for s in range(FOLLOWED_STEPS):
        state, m = step(state, feed(pool[s % len(pool)]), gen)
        losses.append(float(m["loss"]))
        if s == 0:
            grad = _adam_grad_norms(torch, optimizer, params)
            grad_norm = float(m["grad_norm"])
        moments.append(_small(torch, _first_moments(optimizer)))
    deltas = [p.detach().cpu() - q for p, q in zip(params, p0)]
    change = _leaf_norms(torch, deltas)
    elem_grad = []
    for k, b in enumerate(beta1):
        ms = [m[k] for m in moments]
        if any(m is None for m in ms):
            elem_grad.append(None)
            continue
        prev = [np.zeros_like(ms[0])] + ms[:-1]
        elem_grad.append(np.stack([(m - b * q) / (1.0 - b)
                                   for m, q in zip(ms, prev)]))
    return state, {"losses": losses, "grad": grad, "change": change,
                   "grad_norm": grad_norm,
                   "names": [names.get(id(p), "?") for p in params],
                   "elem_grad": elem_grad,
                   "elem_change": _small(torch, deltas)}


def _generator(torch, dev, seed: int):
    return torch.Generator(device=dev).manual_seed(seed % (1 << 63))


def _port(ctx, cfg: dict):
    from sparsebev_tpu_torch.config import Config
    from sparsebev_tpu_torch.models.detector import SparseBEV, _model_kwargs
    from sparsebev_tpu_torch.train.optim import optimizer_from_config
    from sparsebev_tpu_torch.train.step import (create_train_state,
                                                train_step_from_config)
    torch = ctx.torch
    model = build_on_device(torch, lambda: SparseBEV(**_model_kwargs(cfg)),
                            ctx.seed, ctx.device)
    c = Config.fromdict(copy.deepcopy(cfg))
    optimizer, scheduler, _ = optimizer_from_config(
        model, c, ctx.params["schedule_steps"])
    return (create_train_state(model, optimizer, scheduler),
            train_step_from_config(c), optimizer)


def _reference(ctx, cfg: dict, table_round=None):
    import reference.models.detector as rdet
    from reference.train.optim import optimizer_from_config
    from reference.train.step import (create_train_state,
                                      train_step_from_config)
    torch = ctx.torch
    model = build_on_device(torch, lambda: rdet.build_detector(cfg),
                            ctx.seed, ctx.device)
    model.pts_bbox_head.table_round = table_round
    optimizer, scheduler, _ = optimizer_from_config(
        model, cfg, ctx.params["schedule_steps"])
    return (create_train_state(model, optimizer, scheduler),
            train_step_from_config(cfg), optimizer)


def _feed(torch, dev):
    """The loader-to-device feed of the port's training loop."""
    from sparsebev_tpu_torch.train.runner import Runner
    holder = types.SimpleNamespace(device=dev)
    return lambda batch: Runner.upload(holder, batch)


def _reference_feed(torch, dev):
    return lambda batch: {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
                          for k, v in batch.items()}


def _install_annotations(state, patches):
    import sparsebev_tpu_torch.losses.target as target
    import sparsebev_tpu_torch.train.step as step_mod
    trace.annotate(patches, target, "hungarian_matching",
                   "bench.matcher")
    trace.annotate(patches, step_mod, "compute_detection_loss",
                   "bench.losses")
    trace.annotate(patches, step_mod, "clip_by_global_norm",
                   "bench.clip")
    trace.annotate(patches, state.optimizer, "step",
                   "bench.optimizer")


def _run_reference(ctx, pool, table_round=None):
    torch = ctx.torch
    state, step, optimizer = _reference(ctx, ctx.cfg, table_round)
    gen = _generator(torch, ctx.device, ctx.seed)
    _, readings = _followed(torch, state, step,
                            _reference_feed(torch, ctx.device), pool, gen,
                            optimizer)
    del state, step, optimizer
    return readings


def _log_readings(prog, ref):
    """Each step's loss on both sides, the readings kept out of the
    comparison, the leaves that set the worst-leaf gaps, and the worst
    change leaf's elements (where it is small): each step's gradient and
    the change, program and reference, largest change gap first."""
    log("losses: program " + " ".join(f"{x!r}" for x in prog["losses"])
        + " reference " + " ".join(f"{x!r}" for x in ref["losses"]))
    log("not compared: " + " ".join(
        f"{k}={v!r}" for k, v in check.later_gaps(prog, ref).items()))
    moving = check._moving(ref)
    g_p, g_r = np.asarray(prog["grad"]), np.asarray(ref["grad"])
    kept = g_r >= 1e-3 * np.median(g_r)
    gaps = np.abs(g_p - g_r)[kept] / np.maximum(g_r[kept],
                                                np.median(g_r[kept]))
    log(f"grad: global norm before the clip program {prog['grad_norm']!r} "
        f"reference {ref['grad_norm']!r}; leaf gaps quartiles "
        f"{np.quantile(gaps, [0.25, 0.5, 0.75]).tolist()!r}")
    for key, keep in (("grad", np.ones_like(moving)), ("change", moving)):
        p, r = np.asarray(prog[key]), np.asarray(ref[key])
        gap = np.where(keep, np.abs(p - r) / np.maximum(r, np.median(r[keep])),
                       -1.0)
        k = int(np.argmax(gap))
        log(f"{key}: worst leaf {ref['names'][k]} program {float(p[k])!r} "
            f"reference {float(r[k])!r} median {float(np.median(r))!r}")
    gp, gr = prog["elem_grad"][k], ref["elem_grad"][k]
    cp, cr = prog["elem_change"][k], ref["elem_change"][k]
    if gp is None or gr is None or cp is None or cr is None:
        return
    log(f"change: worst leaf's elements: {cr.size}; reference |gradient| "
        f"median a step {np.median(np.abs(gr), axis=1).tolist()!r}, "
        f"program - reference rms a step "
        f"{np.sqrt(np.mean((gp - gr) ** 2, axis=1)).tolist()!r}")
    for i in np.argsort(-np.abs(cp - cr))[:8]:
        log(f"  element {int(i)}: gradient program "
            f"{gp[:, i].tolist()!r} reference {gr[:, i].tolist()!r}; "
            f"change program {float(cp[i])!r} reference {float(cr[i])!r}")


def _free(torch, dev):
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def run(ctx) -> dict:
    torch = ctx.torch
    params = ctx.params
    dev = ctx.device
    pool = traffic.train_pool(torch, dev, ctx.cfg, params, ctx.seed)
    if ctx.control is not None:
        if ctx.control != "fp8tables":
            raise ValueError(f"the train driver has no control "
                             f"{ctx.control!r}")
        # the reference computed with e4m3 tables in the program's place
        prog = _run_reference(ctx, pool, table_round=torch.float8_e4m3fn)
        _free(torch, dev)
        ctx.setup_done()
        ref = _run_reference(ctx, pool)
        _log_readings(prog, ref)
        return dict(attempted=FOLLOWED_STEPS, failed=0, peak=ctx.read_peak(),
                    numbers=check.train_gaps(prog, ref), e2e={},
                    window_s=None, units=0, layer={})

    state, step, optimizer = _port(ctx, ctx.cfg)
    feed = _feed(torch, dev)
    gen = _generator(torch, dev, ctx.seed)
    state, prog = _followed(torch, state, step, feed, pool, gen, optimizer)
    ctx.sync()
    patches = []
    if ctx.trace:
        _install_annotations(state, patches)
    ctx.setup_done()

    n = 0
    t_win = time.perf_counter()
    stamps = [t_win]
    while True:
        state, _ = step(state, feed(pool[(FOLLOWED_STEPS + n) % len(pool)]),
                        gen)
        n += 1
        stamps.append(time.perf_counter())
        if stamps[-1] - t_win >= ctx.seconds:
            break
    ctx.sync()
    window_s = time.perf_counter() - t_win
    peak = ctx.read_peak()
    log(f"train: {n} steps in {window_s:.3f} s "
        f"({1e3 * window_s / n:.3f} ms a step)")
    # host time between the returns of successive steps (each step waits
    # for its matcher's round trip): a stall shows as one long interval
    gaps = 1e3 * np.diff(stamps)
    log("train: step intervals ms min/median/max "
        f"{gaps.min():.1f} {np.median(gaps):.1f} {gaps.max():.1f}; "
        f"longest {np.sort(gaps)[-3:].round(1).tolist()!r}")

    layer = {}
    if ctx.trace:
        calls = trace.KernelCalls(trace.kernel_counters())
        calls.install()
        try:
            calls.active = True
            with trace.profiled(torch) as prof:
                for k in range(params["profile_steps"]):
                    state, _ = step(state, feed(pool[k % len(pool)]), gen)
            calls.active = False
        finally:
            calls.remove()
            trace.unpatch(patches)
        layer["profile"] = trace.summarize(prof.trace, prof.wall_s)
        layer["kernel_bounds"] = calls.bounds(ctx.peaks)
        del calls

    del state, step, optimizer, feed
    _free(torch, dev)
    t_ref = time.perf_counter()
    ref = _run_reference(ctx, pool)
    log(f"reference: {FOLLOWED_STEPS} steps in "
        f"{time.perf_counter() - t_ref:.3f} s")
    if ctx.trace:
        layer["model_flops"] = flops.train_step_flops(torch, ctx.cfg,
                                                      params["batch"])
    _log_readings(prog, ref)
    return dict(attempted=n, failed=0, numbers=check.train_gaps(prog, ref),
                peak=peak, e2e={"train_ms": 1e3 * window_s / n},
                window_s=window_s, units=n, layer=layer)
