"""Checkpoint and resume of the port (``heat_tpu_torch.checkpoint``).

A run checkpointed after epoch 1 and resumed in a fresh engine trains
epoch 2 bit for bit as the uninterrupted run does: the loss, every state
tensor (``attn_q`` and the optimizer slots included), the sampler state,
the numpy generator of the sub-epochs and the torch generator's next draw.
The JAX package's recipe (``tests/test_checkpoint.py``: 60 x 120 clicks,
seed 5) in five configurations, two of which the JAX package's own resume
gets wrong (pinned at the end of this file): sub-epochs, whose item
permutations come from a numpy generator its checkpoint leaves out, and
``shuffle_mode: once``, whose stream it draws again from a later key.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from heat_tpu_torch import main as tmain
from heat_tpu_torch.checkpoint import CheckpointManager
from heat_tpu_torch.config import CFConfig
from heat_tpu_torch.data.synthetic import synthetic_click_dataset as tsynthetic
from heat_tpu_torch.train.engine import Engine

CONFIG0 = "benchmarks/AmazonBooks/config0.yaml"
BASE = dict(emb_dim=8, num_negs=4, max_his=6, l_r=0.05, batch_size=128,
            milestones=[10], seed=5)
CASES = {
    "default": {},
    "subepochs": {"num_subepochs": 2},
    "once": {"shuffle_mode": "once"},
    "headline_bf16_direct": {
        "neg_sampler": 1, "tile_size": 16, "refresh_interval": 64,
        "his_refresh": "subepoch", "param_dtype": "bfloat16",
        "compute_dtype": "bfloat16", "update_mode": "direct"},
    "self_attention_adam": {"aggregator": "self_attention",
                            "optimizer": "adam"},
}


def _data():
    return tsynthetic(num_users=60, num_items=120, clicks_per_user=15,
                      max_his=6, seed=2)


def _engine(override):
    train, test = _data()
    return Engine(CFConfig(**{**BASE, **override}), train, test, device="cpu")


def _tensors(engine) -> dict:
    """Every tensor of the state and the sampler, by name."""
    out = {}
    for f in dataclasses.fields(engine.state):
        value = getattr(engine.state, f.name)
        if isinstance(value, dict):
            out.update({f"opt_slots.{k}": v for k, v in value.items()})
        elif value is not None:
            out[f.name] = value
    for name in ("iterations", "tile"):
        value = getattr(engine.sampler_state, name)
        if value is not None:
            out[f"sampler.{name}"] = value
    return out


def _next_draw(engine) -> torch.Tensor:
    return torch.randint(0, 2**31 - 1, (16,), generator=engine.generator)


@pytest.mark.parametrize("override", list(CASES.values()), ids=list(CASES))
def test_resume_equals_the_uninterrupted_run(tmp_path, override):
    full = _engine(override)
    full.train_one_epoch()
    CheckpointManager(str(tmp_path)).save(full)
    loss_full = full.train_one_epoch()

    resumed = _engine(override)
    mgr = CheckpointManager(str(tmp_path))
    assert mgr.restore_latest(resumed) == 1
    assert resumed.epoch == 1
    loss_resumed = resumed.train_one_epoch()
    mgr.close()

    assert loss_resumed == loss_full
    want, got = _tensors(full), _tensors(resumed)
    assert set(got) == set(want)
    if override.get("aggregator") == "self_attention":
        assert "attn_q" in got and "opt_slots.attn_q_m" in got
    for name in want:
        assert got[name].dtype == want[name].dtype, name
        assert torch.equal(got[name], want[name]), name
    assert full._np_rng.bit_generator.state == resumed._np_rng.bit_generator.state
    assert torch.equal(_next_draw(resumed), _next_draw(full))


def test_max_to_keep_and_an_empty_directory(tmp_path):
    """The newest ``max_to_keep`` checkpoints stay; None keeps them all, as
    Orbax's ``max_to_keep=None`` does under the JAX package's manager."""
    engine = _engine({})
    for max_to_keep, kept in ((3, [3, 4, 5]), (None, [1, 2, 3, 4, 5])):
        where = tmp_path / f"keep_{max_to_keep}" / "dir"
        mgr = CheckpointManager(str(where), max_to_keep=max_to_keep)
        assert mgr.latest_step() is None
        engine.epoch = 0
        assert mgr.restore_latest(engine) is None and engine.epoch == 0
        for epoch in range(1, 6):
            engine.epoch = epoch
            mgr.save(engine)
        assert mgr.all_steps() == kept
        assert sorted(p.name for p in where.iterdir()) == [
            f"ckpt_{e}.pt" for e in kept]
        engine.epoch = 0
        assert mgr.restore_latest(engine) == 5 and engine.epoch == 5


def test_restore_refuses_another_device_types_generator(tmp_path):
    """A CUDA generator's state does not fit a CPU generator: a checkpoint
    from the card raises before it changes the engine."""
    src = _engine({})
    src.train_one_epoch()
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(src)
    path = tmp_path / "ckpt_1.pt"
    payload = torch.load(path, weights_only=True)
    # What a CUDA generator's get_state() holds: a seed and an offset.
    payload["generator"] = {"device": "cuda",
                            "state": torch.zeros(16, dtype=torch.uint8)}
    torch.save(payload, path)
    engine = _engine({})
    before = _tensors(engine)
    generator = engine.generator.get_state()
    with pytest.raises(ValueError, match="cuda generator state"):
        mgr.restore_latest(engine)
    assert torch.equal(engine.generator.get_state(), generator)
    assert engine.epoch == 0
    for name, value in _tensors(engine).items():
        assert torch.equal(value, before[name]), name


def test_restore_refuses_another_configuration(tmp_path):
    """Every field is checked before any is written."""
    src = _engine({})
    src.train_one_epoch()
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(src)
    for override, match in (({"optimizer": "adagrad"}, "opt_slots"),
                            ({"emb_dim": 16}, "user_emb"),
                            ({"neg_sampler": 1, "tile_size": 16}, "tile")):
        engine = _engine(override)
        before = _tensors(engine)
        with pytest.raises(ValueError, match=match):
            mgr.restore_latest(engine)
        assert engine.epoch == 0
        for name, value in _tensors(engine).items():
            assert torch.equal(value, before[name]), name


def test_restore_drops_the_captures_and_keeps_the_tensors(tmp_path):
    engine = _engine({"shuffle_mode": "once"})
    engine.train_one_epoch()
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(engine)
    engine.train_one_epoch()
    assert engine._epoch_fns
    addresses = {k: v.data_ptr() for k, v in _tensors(engine).items()}
    assert mgr.restore_latest(engine) == 1
    assert not engine._epoch_fns
    assert {k: v.data_ptr() for k, v in _tensors(engine).items()} == addresses
    assert engine._once_cached()


def _cli(args, capsys):
    record = tmain.main(["--config", CONFIG0, "--synthetic", "200,400",
                         "--device", "cpu"] + args)
    return record, capsys.readouterr().out


def test_cli_resumes_to_the_uninterrupted_run(tmp_path, capsys):
    """3 epochs, then the same --checkpoint-dir to 5: the final metrics,
    the last losses and the final checkpoint equal an uninterrupted 5-epoch
    run's."""
    part = str(tmp_path / "part")
    first, _ = _cli(["--epochs", "3", "--checkpoint-dir", part], capsys)
    rest, out = _cli(["--epochs", "5", "--checkpoint-dir", part], capsys)
    assert "resumed from epoch 3" in out.splitlines()
    whole = str(tmp_path / "whole")
    full, out = _cli(["--epochs", "5", "--checkpoint-dir", whole], capsys)
    assert "resumed" not in out
    assert first["losses"] + rest["losses"] == full["losses"]
    assert rest["final_metrics"] == full["final_metrics"]
    assert [e["epoch"] for e in rest["evals"]] == [4]
    a = torch.load(tmp_path / "part" / "ckpt_5.pt", weights_only=True)
    b = torch.load(tmp_path / "whole" / "ckpt_5.pt", weights_only=True)
    for name, value in a["state"].items():
        if value is not None:
            assert torch.equal(value, b["state"][name]), name
    assert torch.equal(a["generator"]["state"], b["generator"]["state"])
    assert CheckpointManager(whole).all_steps() == [3, 4, 5]


def _chip_smoke():
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_the_card_resume_checks_epoch_sums_and_pooled_spread():
    """The helpers of ``chip_smoke.py`` ``check_resume_cli``: an epoch loss
    is its steps' f32 loss sums over the training pairs, two sub-epochs'
    partial sums added, within the bound of f32 summation, and a step
    dropped or counted twice is refused; the pooled spread is the root mean
    square over every element of the pairs and the largest difference."""
    smoke = _chip_smoke()
    rng = np.random.default_rng(0)
    size = 1_895_148
    epochs = [torch.from_numpy(rng.uniform(2e3, 2e4, n).astype(np.float32))
              for n in (232, 233, 232)]
    losses = []
    for steps in epochs:
        halves = [steps[: len(steps) // 2], steps[len(steps) // 2:]]
        total = torch.zeros((), dtype=torch.float32)
        for half in halves:
            part = torch.zeros((), dtype=torch.float32)
            for x in half:
                part += x
            total += part
        losses.append(float(total) / size)
    as_f64 = [steps.double() for steps in epochs]
    smoke.check_epoch_sums("sums", losses, as_f64, [size] * 3)
    for wrong in (as_f64[1][1:], torch.cat([as_f64[1], as_f64[1][:1]])):
        with pytest.raises(AssertionError, match="epoch 1 loss"):
            smoke.check_epoch_sums("sums", losses, [as_f64[0], wrong, as_f64[2]],
                                   [size] * 3)
    with pytest.raises(AssertionError, match="3 epoch losses, 2 epochs"):
        smoke.check_epoch_sums("sums", losses, as_f64[:2], [size] * 2)

    a, b, c = (torch.from_numpy(rng.normal(size=(50, 4))) for _ in range(3))
    rms, worst = smoke.pooled_rms_diff([(a, b), (a, c)])
    d = torch.cat([a - b, a - c])
    assert rms == pytest.approx(float(d.pow(2).mean().sqrt()), rel=1e-12)
    assert worst == float(d.abs().max())
    assert smoke.pooled_rms_diff([(a, a), (b, b)]) == (0.0, 0.0)


def test_cli_fused_run_saves_once_at_the_end(tmp_path, capsys):
    ck = tmp_path / "ck"
    record, _ = _cli(["--epochs", "3", "--fused-run", "--checkpoint-dir",
                      str(ck)], capsys)
    assert len(record["losses"]) == 3
    assert CheckpointManager(str(ck)).all_steps() == [3]
    again, out = _cli(["--epochs", "3", "--fused-run", "--checkpoint-dir",
                       str(ck)], capsys)
    assert "resumed from epoch 3" in out and again["losses"] == []
    assert again["final_metrics"] == record["final_metrics"]
    json.dumps(again)


@pytest.mark.parametrize("override,exact", [
    ({}, True), ({"num_subepochs": 2}, False), ({"shuffle_mode": "once"}, False),
], ids=["default", "subepochs", "once"])
def test_jax_resume_is_inexact_under_subepochs_and_once(tmp_path, override, exact):
    """The JAX package's own checkpoint recipe, where its resume is exact
    and where it is not: its CheckpointManager saves neither the sub-epochs'
    numpy generator nor the "once" stream (drawn again from a later key
    after a restore). The port's resume is exact in all three
    (``test_resume_equals_the_uninterrupted_run``): a deliberate
    difference, not a copy."""
    from heat_tpu.checkpoint import CheckpointManager as JCheckpointManager
    from heat_tpu.config import CFConfig as JCFConfig
    from heat_tpu.data.synthetic import synthetic_click_dataset as jsynthetic
    from heat_tpu.train.engine import Engine as JEngine

    train, test = jsynthetic(num_users=60, num_items=120, clicks_per_user=15,
                             max_his=6, seed=2)
    e1 = JEngine(JCFConfig(**BASE, **override), train, test)
    e1.train_one_epoch()
    mgr = JCheckpointManager(str(tmp_path / "ck"))
    mgr.save(e1)
    loss_full = e1.train_one_epoch()
    mgr.close()
    e2 = JEngine(JCFConfig(**BASE, **override), train, test)
    mgr2 = JCheckpointManager(str(tmp_path / "ck"))
    assert mgr2.restore_latest(e2) == 1
    loss_resumed = e2.train_one_epoch()
    mgr2.close()
    same = np.array_equal(np.asarray(e1.state.item_emb),
                          np.asarray(e2.state.item_emb))
    assert same == exact
    assert (loss_resumed == loss_full) == exact
