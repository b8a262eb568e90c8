"""The port's verified checkpoints (``horovod_tpu_torch/checkpoint.py``)
and training callbacks (``horovod_tpu_torch/callbacks.py``) against the
JAX package's (``horovod_tpu/checkpoint.py``, ``horovod_tpu/callbacks.py``),
after the reference tests of ``tests/test_checkpoint.py`` and
``tests/test_callbacks.py``.

* Walk-back: the same steps saved by both managers, the same damage
  (``bitflip``, ``truncate``, a corrupt sidecar, every step corrupt, a
  pinned corrupt step): the same restored step (or the same error) and
  the same ``hvd_tpu_checkpoint_verify_total{result=}`` deltas. The
  sidecar has the JAX schema; the port's algorithm is ``"crc32"``.
* Save copies to the host before it returns (a later in-place update
  does not reach the file); ``restore(target=)`` keeps the target's
  dtype and device; a model, AdamW and the guard restored from a
  checkpoint continue bitwise as the uninterrupted run.
* Callbacks: the learning-rate schedules give JAX's rates step by step
  (at a world of 8, as the JAX suite runs them); ``Trainer.lr`` writes
  every parameter group; ``BestModelCheckpoint`` keeps the best epoch;
  the elastic-state callbacks commit and track batch and epoch.
"""

import json
import os
import types

import numpy as np
import pytest
import torch

import horovod_tpu_torch as hvd
from horovod_tpu_torch import callbacks as cb
from horovod_tpu_torch import checkpoint as ckpt
from horovod_tpu_torch.common import basics
from horovod_tpu_torch.common import metrics as metrics_lib


@pytest.fixture(scope="module")
def J():
    import jax.numpy as jnp

    from horovod_tpu import callbacks as jcb
    from horovod_tpu import checkpoint as jckpt
    from horovod_tpu.common import metrics as jmetrics
    from horovod_tpu.common.exceptions import CheckpointCorruptError

    return types.SimpleNamespace(jnp=jnp, ckpt=jckpt, cb=jcb,
                                 metrics=jmetrics,
                                 CheckpointCorruptError=CheckpointCorruptError)


@pytest.fixture()
def world1():
    ctx = hvd.init(device="cpu")
    try:
        yield ctx
    finally:
        hvd.shutdown()


def _verify_counts(snapshot):
    fam = snapshot.get("hvd_tpu_checkpoint_verify_total", {})
    out = {}
    for s in fam.get("samples", []):
        out[s["labels"]["result"]] = out.get(s["labels"]["result"], 0) + \
            s["value"]
    return out


def _delta(before, after):
    return {k: after.get(k, 0) - before.get(k, 0)
            for k in set(before) | set(after)
            if after.get(k, 0) != before.get(k, 0)}


def _scenario(mgr, mode, restored_step, error_cls):
    """Damage the saved steps 0..2 per ``mode`` and restore; returns the
    restored step (or the error's class name)."""
    if mode == "all_corrupt":
        for step in (0, 1, 2):
            mgr._corrupt_step(step, "bitflip")
    elif mode == "pinned":
        mgr._corrupt_step(1, "bitflip")
    else:
        mgr._corrupt_step(2, mode)
    try:
        if mode == "pinned":
            try:
                mgr.restore(step=1)
            except error_cls:
                pass
            else:
                return "loaded a pinned corrupt step"
            return restored_step(mgr.restore(step=0))
        return restored_step(mgr.restore())
    except error_cls as e:
        return type(e).__name__ + (": last-good" if "last-good" in str(e)
                                   else "")


@pytest.mark.parametrize("mode", ["bitflip", "truncate", "sidecar",
                                  "all_corrupt", "pinned"])
def test_walk_back_matches_jax(J, tmp_path, mode):
    """Both managers restore the same step (or raise the same error) and
    count the same verifications by result."""
    results, deltas = [], []
    for side in ("jax", "port"):
        d = str(tmp_path / side)
        if side == "jax":
            mgr = J.ckpt.CheckpointManager(d, max_to_keep=4)
            snap = J.metrics.snapshot
            tree = lambda s: {"w": J.jnp.full(256, float(s)), "step": s}
            restored = lambda out: int(np.asarray(out["step"]))
            err = J.CheckpointCorruptError
        else:
            mgr = ckpt.CheckpointManager(d, max_to_keep=4)
            snap = metrics_lib.metrics
            tree = lambda s: {"w": torch.full((256,), float(s)), "step": s}
            restored = lambda out: int(out["step"])
            err = hvd.CheckpointCorruptError
        with mgr:
            for step in range(3):
                mgr.save(step, tree(step), force=True)
            mgr.wait()
            before = _verify_counts(snap())
            results.append(_scenario(mgr, mode, restored, err))
            deltas.append(_delta(before, _verify_counts(snap())))
    assert results[0] == results[1], (mode, results)
    assert deltas[0] == deltas[1], (mode, deltas)
    want = {"bitflip": 1, "truncate": 1, "sidecar": 1, "pinned": 0,
            "all_corrupt": "CheckpointCorruptError: last-good"}[mode]
    assert results[1] == want


def test_sidecar_schema_matches_jax(J, tmp_path):
    with J.ckpt.CheckpointManager(str(tmp_path / "j")) as jm:
        jm.save(0, {"w": J.jnp.arange(8.0)})
        jm.wait()
        with open(jm._sidecar_path(0)) as f:
            jside = json.load(f)
    with ckpt.CheckpointManager(str(tmp_path / "p")) as pm:
        pm.save(0, {"w": torch.arange(8.0)})
        pm.wait()
        with open(pm._sidecar_path(0)) as f:
            pside = json.load(f)
        assert pm.verify_step(0) == "ok"
    assert set(pside) == set(jside) == {"algo", "step", "files"}
    assert pside["algo"] == "crc32" and pside["step"] == jside["step"] == 0
    for side in (pside, jside):
        for meta in side["files"].values():
            assert set(meta) == {"size", "crc"}
    payload = tmp_path / "p" / "0" / ckpt.PAYLOAD_NAME
    assert pside["files"] == {ckpt.PAYLOAD_NAME: {
        "size": payload.stat().st_size,
        "crc": ckpt._crc_file(str(payload))}}


def test_save_restore_roundtrip(tmp_path):
    tree = {"w": torch.arange(8.0), "b": {"x": torch.ones(2, 3)},
            "n": 3, "l": [torch.zeros(2, dtype=torch.int64)]}
    with ckpt.CheckpointManager(str(tmp_path / "c"), max_to_keep=2) as mgr:
        assert mgr.save(0, tree)
        mgr.wait()
        out = mgr.restore()
    assert torch.equal(out["w"], tree["w"]) and out["n"] == 3
    assert torch.equal(out["b"]["x"], tree["b"]["x"])
    assert out["l"][0].dtype == torch.int64
    assert mgr.last_restored_step == 0


def test_max_to_keep_gc_and_interval(tmp_path):
    tree = {"w": torch.zeros(4)}
    with ckpt.CheckpointManager(str(tmp_path / "c"), max_to_keep=2) as mgr:
        for step in range(5):
            mgr.save(step, tree, force=True)
        mgr.wait()
        assert mgr.all_steps() == [3, 4] and mgr.latest_step() == 4
    with ckpt.CheckpointManager(str(tmp_path / "i"),
                                save_interval_steps=2) as mgr:
        assert [mgr.save(s, tree) for s in range(5)] == [
            True, False, True, False, True]
        with pytest.raises(ValueError, match="already exists"):
            mgr.wait() or mgr.save(4, tree, force=True)


def test_save_copies_before_it_returns(tmp_path):
    """The host copy is made on the caller's thread: an update right
    after ``save`` does not reach the checkpoint."""
    w = torch.zeros(1 << 16)
    with ckpt.CheckpointManager(str(tmp_path / "c")) as mgr:
        mgr.save(0, {"w": w})
        w.add_(1.0)
        mgr.wait()
        assert not mgr.restore()["w"].any()
        assert mgr.payload_bytes[0] > w.numel() * 4
        assert mgr.write_seconds[0] >= 0


def test_restore_with_target_preserves_dtype(tmp_path):
    tree = {"w": torch.arange(4, dtype=torch.bfloat16), "k": 2}
    with ckpt.CheckpointManager(str(tmp_path / "c")) as mgr:
        mgr.save(0, {"w": torch.arange(4.0), "k": 2})
        mgr.wait()
        out = mgr.restore(target=tree)
    assert out["w"].dtype == torch.bfloat16 and out["k"] == 2
    assert torch.equal(out["w"], tree["w"])


def test_restore_empty_raises(tmp_path):
    with ckpt.CheckpointManager(str(tmp_path / "c")) as mgr:
        with pytest.raises(FileNotFoundError):
            mgr.restore()
        assert mgr.latest_verified_step() is None


def test_verify_disabled_and_missing_sidecar(tmp_path):
    """verify=False writes no sidecar and restores blindly; a step without
    a sidecar restores under verification too, counted as "missing"."""
    d = str(tmp_path / "c")
    with ckpt.CheckpointManager(d, max_to_keep=4, verify=False) as mgr:
        for s in range(2):
            mgr.save(s, {"step": s}, force=True)
        mgr.wait()
        assert not os.path.exists(mgr._sidecar_path(1))
        assert mgr.latest_verified_step() == 1
    before = _verify_counts(metrics_lib.metrics())
    with ckpt.CheckpointManager(d, max_to_keep=4) as mgr:
        assert mgr.restore()["step"] == 1
    assert _delta(before, _verify_counts(metrics_lib.metrics())) == {
        "missing": 1}


def test_corruption_bumps_recovery_stats(tmp_path):
    with ckpt.CheckpointManager(str(tmp_path / "c"), max_to_keep=4) as mgr:
        for s in range(2):
            mgr.save(s, {"step": s, "w": torch.ones(64)}, force=True)
        mgr.wait()
        before = hvd.recovery_stats()["checkpoint_corruptions"]
        mgr._corrupt_step(1, "bitflip")
        assert mgr.latest_verified_step() == 0
        assert hvd.recovery_stats()["checkpoint_corruptions"] == before + 1


def test_object_store(tmp_path):
    store = ckpt.ObjectStore(str(tmp_path / "s"))
    store.put("meta", {"epoch": 3, "rng": [1, 2, 3]})
    assert store.get("meta") == {"epoch": 3, "rng": [1, 2, 3]}
    assert store.get("missing", default=7) == 7
    assert store.exists("meta") and not store.exists("missing")


def test_later_slices_raise():
    """The elastic slice's names raise naming it; the ZeRO slice's
    sharded checkpoints are ported."""
    for name in ("save_state", "restore_state"):
        with pytest.raises(NotImplementedError, match="elastic"):
            getattr(ckpt, name)
    assert callable(ckpt.save_sharded) and callable(ckpt.restore_sharded)


def test_training_resumes_bitwise_from_a_checkpoint(world1, tmp_path):
    """Model, AdamW state and the scale_backoff guard saved at step 2 and
    restored into a fresh model and optimizer: the next steps equal the
    uninterrupted run's bitwise (a non-finite step included)."""
    x = torch.randn(8, 5, generator=torch.Generator().manual_seed(0))
    y = torch.randn(8, 3, generator=torch.Generator().manual_seed(1))

    def fresh():
        torch.manual_seed(0)
        m = torch.nn.Sequential(torch.nn.Linear(5, 4), torch.nn.Tanh(),
                                torch.nn.Linear(4, 3))
        return m, hvd.DistributedOptimizer(
            torch.optim.AdamW(m.parameters(), lr=1e-2),
            named_parameters=m.named_parameters(),
            nonfinite_policy="scale_backoff")

    def step(m, opt, poison=False):
        opt.zero_grad()
        loss = ((m(x) - y) ** 2).mean() * hvd.current_loss_scale(opt)
        (loss * float("inf") if poison else loss).backward()
        opt.step()

    m, opt = fresh()
    for _ in range(2):
        step(m, opt)
    with ckpt.CheckpointManager(str(tmp_path / "c"), max_to_keep=2) as mgr:
        mgr.save(2, {"model": m.state_dict(),
                     "optimizer": opt.state_dict()})
        for poison in (True, False):
            step(m, opt, poison)
        mgr.wait()
        tree = mgr.restore()
    m2, opt2 = fresh()
    m2.load_state_dict(tree["model"])
    opt2.load_state_dict(tree["optimizer"])
    assert tree["optimizer"]["guard_state"]["loss_scale"] == 2.0 ** 15
    for poison in (True, False):
        step(m2, opt2, poison)
    for (k, a), b in zip(m.state_dict().items(), m2.state_dict().values()):
        assert torch.equal(a, b), k
    assert hvd.observe_guard(opt2) == hvd.observe_guard(opt)
    assert hvd.current_loss_scale(opt2) == 2.0 ** 14


# -- callbacks ---------------------------------------------------------------

def _trainer(lr=0.0):
    m = torch.nn.Linear(3, 1)
    return cb.Trainer(m, torch.optim.SGD(m.parameters(), lr=lr))


def test_callback_list_dispatch_and_binding():
    seen = []

    class Probe(cb.Callback):
        def on_epoch_begin(self, epoch, logs=None):
            seen.append(epoch)

    t = _trainer()
    cl = cb.CallbackList([Probe(), Probe()], t)
    cl.on_epoch_begin(3)
    assert seen == [3, 3]
    assert all(c.trainer is t for c in cl.callbacks)
    with pytest.raises(AttributeError):
        cl.not_a_hook


def test_trainer_lr_writes_every_group():
    a, b = torch.nn.Linear(2, 2), torch.nn.Linear(2, 2)
    opt = torch.optim.SGD([{"params": a.parameters()},
                           {"params": b.parameters(), "lr": 0.5}], lr=0.1)
    t = cb.Trainer(a, opt, lr=0.25)
    assert [g["lr"] for g in opt.param_groups] == [0.25, 0.25]
    assert t.lr == 0.25


def test_broadcast_and_metric_average_callbacks(world1):
    t = _trainer(0.1)
    w = t.model.weight.detach().clone()
    cl = cb.CallbackList([cb.BroadcastVariablesCallback(0),
                          cb.MetricAverageCallback()], t)
    cl.on_train_begin()
    assert torch.equal(t.model.weight, w)
    logs = {"loss": 2.0, "name": "not-a-number"}
    cl.on_epoch_end(0, logs)
    assert logs == {"loss": pytest.approx(2.0), "name": "not-a-number"}


def _rates(callbacks, trainer, script):
    cl = callbacks(trainer)
    out = []
    for hook, arg in script:
        getattr(cl, hook)(arg)
        out.append(trainer.lr)
    return out


@pytest.mark.parametrize("case", ["staircase", "warmup", "warmup_epochs",
                                  "warmup_then_decay"])
def test_lr_schedules_match_jax(J, hvd, world1, monkeypatch, case):
    """The rate after each hook equals the JAX callbacks' on a trainer
    with a scalar ``lr``, at the JAX suite's world of 8."""
    monkeypatch.setattr(basics, "size", lambda: 8)
    script = {"staircase": [("on_epoch_begin", e) for e in (0, 1, 2, 5)],
              "warmup": [("on_epoch_begin", 0), ("on_batch_begin", 0),
                         ("on_batch_begin", 2), ("on_epoch_begin", 1),
                         ("on_batch_begin", 4)],
              "warmup_epochs": [("on_epoch_begin", 0),
                                ("on_epoch_begin", 1),
                                ("on_epoch_begin", 2)],
              "warmup_then_decay": [("on_epoch_begin", 3),
                                    ("on_batch_begin", 1)]}[case]

    def make(mod):
        def build(trainer):
            if case == "staircase":
                cbs = [mod.LearningRateScheduleCallback(
                    initial_lr=0.1, multiplier=lambda e: 0.5 ** e,
                    start_epoch=1, end_epoch=3)]
            elif case == "warmup_epochs":
                cbs = [mod.LearningRateWarmupCallback(initial_lr=0.8,
                                                      warmup_epochs=2)]
            else:
                cbs = [mod.LearningRateWarmupCallback(
                    initial_lr=0.8, warmup_epochs=2, steps_per_epoch=4)]
                if case == "warmup_then_decay":
                    cbs.append(mod.LearningRateScheduleCallback(
                        initial_lr=0.8, multiplier=lambda e: 0.1,
                        start_epoch=3, steps_per_epoch=4))
            return mod.CallbackList(cbs, trainer)
        return build

    want = _rates(make(J.cb), types.SimpleNamespace(lr=0.0), script)
    got = _rates(make(cb), _trainer(0.0), script)
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert len(set(want)) > 1 or case == "warmup_then_decay"


def test_best_model_checkpoint(tmp_path):
    t = _trainer()
    best = cb.BestModelCheckpoint(str(tmp_path / "best"), monitor="val_loss",
                                  mode="min", save_optimizer=True)
    cl = cb.CallbackList([best], t)
    cl.on_train_begin()
    for epoch, (value, loss) in enumerate(((1.0, 1.0), (2.0, 2.0),
                                           (3.0, 0.5))):
        with torch.no_grad():
            t.model.weight.fill_(value)
        cl.on_epoch_end(epoch, {"val_loss": loss})
    cl.on_train_end()
    with ckpt.CheckpointManager(str(tmp_path / "best")) as mgr:
        assert mgr.all_steps() == [2]
        out = mgr.restore()
    assert torch.equal(out["model"]["weight"], torch.full((1, 3), 3.0))
    assert "param_groups" in out["optimizer"]
    with pytest.raises(ValueError, match="min|max"):
        cb.BestModelCheckpoint(str(tmp_path / "x"), mode="median")


def test_elastic_state_callbacks():
    commits = []
    state = types.SimpleNamespace(batch=0, epoch=0,
                                  commit=lambda: commits.append(True))
    cl = cb.CallbackList([cb.CommitStateCallback(state, 2),
                          cb.UpdateBatchStateCallback(state),
                          cb.UpdateEpochStateCallback(state)], _trainer())
    cl.on_epoch_begin(4)
    assert state.epoch == 4
    cl.on_batch_end(0)
    cl.on_batch_end(1)
    assert state.batch == 2 and len(commits) == 1
    cl.on_epoch_end(4)
    assert state.batch == 0
