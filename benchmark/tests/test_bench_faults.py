"""The comparison catches a broken timed path: a tiny run on the CPU with
a fault planted in the port underneath, and ``correct`` comes out false.
The cells run on one card with a batch of one, so of the contract's faults
they can have an answer altered where it is produced (both kinds of cell)
and a step that returns its state unchanged (training); and a backward
that scales its gradients, which AdamW's update would hide from the
change (``vov99.train``: the sampling backward and the pair pack's
adjoint, its only path)."""

from tiny import run_tiny


def test_stream_answer_altered(monkeypatch):
    from sparsebev_tpu_torch.bbox import nms_free_coder
    orig = nms_free_coder.NMSFreeCoder.decode

    def altered(self, preds):
        out = orig(self, preds)
        out["scores"] = out["scores"].clone()
        out["scores"][:, 0] += 0.01
        return out

    monkeypatch.setattr(nms_free_coder.NMSFreeCoder, "decode", altered)
    res = run_tiny("vov99.stream", seconds=0.2)
    assert res["correct"] is False
    assert res["compared"]["score_gap"]["value"] > 0


def _port_only(monkeypatch, wrap):
    """Apply ``wrap`` to the port's training state only (the reference runs
    the copy in ``benchmark/reference/``)."""
    from harness import train
    orig = train._port

    def port(ctx, cfg):
        state, step, optimizer = orig(ctx, cfg)
        return wrap(state, step, optimizer)

    monkeypatch.setattr(train, "_port", port)


def test_train_step_returns_state_unchanged(monkeypatch):
    def wrap(state, step, optimizer):
        optimizer.step = lambda *a, **k: None
        return state, step, optimizer

    _port_only(monkeypatch, wrap)
    res = run_tiny("r101.train", seconds=0.2)
    assert res["correct"] is False
    # every moving leaf unmoved: the median leaf's gap reads about 1
    assert res["compared"]["change_gap"]["value"] > 0.9


def test_train_loss_altered(monkeypatch):
    import sparsebev_tpu_torch.train.step as step_mod
    orig = step_mod.compute_detection_loss

    def altered(*a, **k):
        losses = orig(*a, **k)
        key = next(iter(losses))
        losses[key] = losses[key] * 1.05
        return losses

    monkeypatch.setattr(step_mod, "compute_detection_loss", altered)
    res = run_tiny("r101.train", seconds=0.2)
    assert res["correct"] is False


def test_train_sampling_backward_scaled(monkeypatch):
    from sparsebev_tpu_torch.ops import msmv_sampling
    orig = msmv_sampling.msmv_sampling_backward
    calls = []

    def scaled(packed, loc, sw, grad_out, table_grads=None):
        calls.append(1)
        return orig(packed, loc, sw, 2.0 * grad_out, table_grads)

    scaled.launches = orig.launches  # the CUDA path counts launches here
    monkeypatch.setattr(msmv_sampling, "msmv_sampling_backward", scaled)
    res = run_tiny("vov99.train", seconds=0.2)
    assert calls and res["correct"] is False
    c = res["compared"]["grad_median_gap"]
    assert c["value"] > c["limit"]


def test_train_pair_adjoint_scaled(monkeypatch):
    from sparsebev_tpu_torch.ops import msmv_pack
    orig = msmv_pack.pack_level_pair_bwd
    calls = []

    def scaled(dt, num_groups):
        calls.append(1)
        return 2.0 * orig(dt, num_groups)

    scaled.launches = orig.launches
    monkeypatch.setattr(msmv_pack, "pack_level_pair_bwd", scaled)
    res = run_tiny("vov99.train", seconds=0.2)
    assert calls and res["correct"] is False
    c = res["compared"]["grad_median_gap"]
    assert c["value"] > c["limit"]
