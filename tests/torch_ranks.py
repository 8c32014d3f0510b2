"""Multi-rank helpers of the port's parallelism tests: :func:`run_ranks`
starts ``world`` processes with ``torch.multiprocessing`` (spawn), joins
them to a gloo group through a ``FileStore`` under the test's temporary
directory (no TCP port, so concurrent test workers cannot clash) and runs a
rank function in each, under a timeout. The rank functions below import
the port and torch only, never JAX: the tests compute the JAX side in their
own process and exchange tensors with the ranks through files.
"""

import copy
import datetime
import os
import time

import numpy as np
import torch
import torch.distributed as dist

RANK_TIMEOUT_S = 240


def _entry(rank, fn, world, workdir, args):
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(os.path.join(workdir, "store"), world),
        rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=RANK_TIMEOUT_S))
    try:
        fn(rank, world, workdir, *args)
    finally:
        dist.destroy_process_group()


def run_ranks(fn, world, workdir, *args, timeout=RANK_TIMEOUT_S):
    """Run ``fn(rank, world, workdir, *args)`` in ``world`` gloo ranks;
    raises if a rank fails or the ranks outlive ``timeout`` seconds."""
    ctx = torch.multiprocessing.start_processes(
        _entry, args=(fn, world, str(workdir), args), nprocs=world,
        join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=5):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{world} ranks still running after "
                                   f"{timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()


# ------------------------------------------------------------ rank functions


def _no_dropout(model):
    from sparsebev_tpu_torch.models import layers as tlayers
    for m in model.modules():
        if isinstance(m, tlayers.Dropout):
            m.p = 0.0
    return model


def train_step_rank(rank, world, workdir, sp, dropout=False):
    """One DN-on train step of the model, weights and global batch saved in
    ``workdir/step_inputs.pt``: data-parallel over ``world // sp`` ranks
    (each its slice of the batch and of the denoising draws) with the
    queries over ``sp``, dropout off unless ``dropout``; with ``sp`` None,
    data-parallel over the ranks the train CLI takes for the batch
    (``make_group_for_batch``), a rank outside them leaving at once (it
    saves ``left_rank{r}.pt``). Rank 0 saves the metrics, the summed
    gradients (read before the clip) and the parameters after the step in
    ``step_w{world}_sp{sp}[_dropout].pt``."""
    from sparsebev_tpu_torch.models.detector import build_detector
    from sparsebev_tpu_torch.parallel import (make_group_for_batch,
                                              make_hybrid_groups, shard_batch)
    from sparsebev_tpu_torch.train import optim as toptim
    from sparsebev_tpu_torch.train import step as tstep

    inp = torch.load(os.path.join(workdir, "step_inputs.pt"))
    if sp is None:
        group, dp = make_group_for_batch(inp["batch"]["img"].shape[0])
        if rank >= dp:
            torch.save(dict(world=world, dp=dp),
                       os.path.join(workdir, f"left_rank{rank}.pt"))
            return
        step_groups, d = tstep.data_parallel_groups(group), rank
    else:
        groups = make_hybrid_groups(world // sp, sp)
        step_groups = (tstep.hybrid_step_groups(groups) if sp > 1
                       else tstep.data_parallel_groups(groups.data))
        d, dp = groups.data_index, groups.dp
    model = build_detector({"model": copy.deepcopy(inp["model"])},
                           device="cpu")
    model.load_state_dict(inp["state_dict"], strict=True)
    if not dropout:
        _no_dropout(model)
    opt, sched = toptim.build_optimizer(model, **inp["opt"])
    step = tstep.make_train_step(**inp["step"], groups=step_groups)
    batch = shard_batch(inp["batch"], d, dp)
    draws = {"dn": shard_batch(inp["dn"], d, dp)}

    grads = {}
    real_clip = tstep.clip_by_global_norm

    def clip_and_record(params, max_norm):
        grads.update({k: p.grad.detach().clone()
                      for k, p in model.named_parameters()})
        return real_clip(params, max_norm)

    tstep.clip_by_global_norm = clip_and_record
    try:
        _, metrics = step(tstep.create_train_state(model, opt, sched), batch,
                          generator=torch.Generator().manual_seed(0),
                          draws=draws)
    finally:
        tstep.clip_by_global_norm = real_clip
    if rank == 0:
        torch.save(dict(metrics={k: float(v) for k, v in metrics.items()},
                        grads=grads,
                        params={k: v.detach().clone()
                                for k, v in model.named_parameters()}),
                   os.path.join(workdir, f"step_w{world}_sp{sp}"
                                f"{'_dropout' if dropout else ''}.pt"))


def stream_rank(rank, world, workdir):
    """The stream of ``workdir/stream_inputs.pt`` through a
    ``StreamingDetector`` whose head is query-sharded over every rank; each
    rank saves its raw predictions a sample."""
    from sparsebev_tpu_torch.inference import StreamingDetector
    from sparsebev_tpu_torch.models.detector import build_detector
    from sparsebev_tpu_torch.parallel import QueryShard

    inp = torch.load(os.path.join(workdir, "stream_inputs.pt"),
                     weights_only=False)
    model = build_detector({"model": copy.deepcopy(inp["model"])},
                           device="cpu")
    model.load_state_dict(inp["state_dict"], strict=True)
    det = StreamingDetector(model, num_frames=inp["num_frames"],
                            cache_size=inp["num_frames"], device="cpu",
                            query_group=dist.group.WORLD)
    outs = [{k: v.numpy() for k, v in det.infer(*s).items()}
            for s in inp["samples"]]
    shard = QueryShard(det.query_group, model.pts_bbox_head.num_query)
    torch.save(dict(outs=outs, lo_hi=(shard.lo, shard.hi)),
        os.path.join(workdir, f"stream_rank{rank}.pt"))


class ScoreModel(torch.nn.Module):
    """A stand-in detector for the evaluation loop: predictions are a fixed
    function of the inputs (the same in numpy for the JAX side)."""

    def __init__(self):
        super().__init__()
        self.scale = torch.nn.Parameter(torch.ones(()))

    def forward(self, img, lidar2img, time_diff, train=False):
        return {k: torch.from_numpy(v) * self.scale.detach()
                for k, v in score_preds(img.numpy(), lidar2img.numpy(),
                                        time_diff.numpy()).items()}


def score_preds(img, lidar2img, time_diff, layers=2, queries=30):
    """Predictions ``[L, B, Q, ...]`` drawn from a seed that the sample's
    pixels give (numpy; the JAX side calls it through a host callback)."""
    out_cls, out_box = [], []
    for i in range(img.shape[0]):
        rng = np.random.RandomState(int(img[i].sum()) % (2 ** 31))
        cls = rng.randn(layers, queries, 10).astype(np.float32) * 3
        box = np.concatenate([
            rng.uniform(-12, 12, (layers, queries, 2)),
            rng.uniform(0.0, 1.5, (layers, queries, 2)),
            rng.uniform(-2, 1, (layers, queries, 1)),
            rng.uniform(0.0, 1.5, (layers, queries, 1)),
            rng.uniform(-1, 1, (layers, queries, 2)),
            rng.uniform(-3, 3, (layers, queries, 2))], -1).astype(np.float32)
        out_cls.append(cls)
        out_box.append(box)
    return {"all_cls_scores": np.stack(out_cls, 1),
            "all_bbox_preds": np.stack(out_box, 1)}


def eval_rank(rank, world, workdir):
    """``run_offline_eval`` of :class:`ScoreModel` over this rank's shard
    of the batches in ``workdir/eval_inputs.pt`` (rank r holds the split's
    samples r, r + world, ..., padded as the sampler pads); rank 0 saves the
    metrics and results."""
    from sparsebev_tpu_torch.bbox.nms_free_coder import NMSFreeCoder
    from sparsebev_tpu_torch.evaluation import run_offline_eval

    inp = torch.load(os.path.join(workdir, "eval_inputs.pt"),
                     weights_only=False)
    samples = inp["samples"]
    per = -(-len(samples) // world)
    order = list(range(len(samples)))
    order += order[:per * world - len(order)]
    loader = [samples[i] for i in order[rank::world]]

    class Split:
        classes = inp["classes"]

        def __len__(self):
            return len(samples)

    metrics, results = run_offline_eval(
        ScoreModel(), NMSFreeCoder(**inp["coder"]), Split(),
        [dict(b) for b in loader], group=None)
    if rank == 0:
        torch.save(dict(metrics=metrics, results=results),
                   os.path.join(workdir, "eval_out.pt"))
    else:
        assert metrics is None and results == {}


class MetricsRecorder:
    """A hook that keeps every step's metrics."""

    def __init__(self):
        self.metrics = []

    def after_iter(self, runner, metrics):
        self.metrics.append(dict(metrics))


def cli_rank(rank, world, workdir, cli, argv):
    """The train or val CLI in a rank, with the torchrun environment set
    (the group is already up, so ``init_from_env`` joins it); rank r saves
    the train CLI's step metrics or the val CLI's results (a train rank
    that the batch leaves out saves ``left=True``)."""
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), MASTER_ADDR="127.0.0.1",
                      MASTER_PORT="1")
    from sparsebev_tpu_torch.tools import train, val
    if cli == "train":
        rec = MetricsRecorder()
        runner = train.main(argv, extra_hooks=[rec])
        if runner is None:
            torch.save(dict(left=True, metrics=rec.metrics),
                       os.path.join(workdir, f"{cli}_rank{rank}.pt"))
            return
        out = dict(metrics=rec.metrics, step=runner.global_step,
                   eval=runner.eval_results,
                   params={k: v.detach().clone() for k, v in
                           runner.state.model.named_parameters()})
    else:
        out = val.main(argv)
        out = dict(results=out["results"], metrics=out["metrics"])
    torch.save(out, os.path.join(workdir, f"{cli}_rank{rank}.pt"))
