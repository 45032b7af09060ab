"""The port's fused programs: ``Engine.train_epochs``,
``Engine.run_epochs_with_eval``, the CLI's ``--fused-epochs`` /
``--fused-run`` and the captured step (``train_step.make_epoch_fn``).

On the CPU the steps run eagerly (a CUDA graph needs a card), so these
tests hold the fused API, the schedule and the in-place invariants that
capture rests on: the ports of the JAX package's own tests of its fused
programs (tests/test_engine.py), against the JAX engine where both can see
the same draws. The ``cuda``-marked tests hold the captured step against
the eager one on the card and skip without one; JAX is imported inside the
tests that use it, so that the card's machine can run them:
``python -m pytest --noconftest -m cuda tests/test_torch_fused.py``.
"""

import json
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import heat_tpu_torch.train.train_step as tts
from heat_tpu_torch import bench_large
from heat_tpu_torch import main as tmain
from heat_tpu_torch.config import CFConfig
from heat_tpu_torch.data.synthetic import synthetic_click_dataset
from heat_tpu_torch.models.aggregator import user_pools_impl
from heat_tpu_torch.models.state import init_train_state
from heat_tpu_torch.ops.cuda import gather, scatter, topk
from heat_tpu_torch.testing import (
    StepRecorder,
    distinct_id_dataset,
    replayed_equals_eager,
)
from heat_tpu_torch.train.engine import Engine
from heat_tpu_torch.train.run import reference_schedule
from heat_tpu_torch.train.samplers import init_sampler_state

CONFIG0 = "benchmarks/AmazonBooks/config0.yaml"
METRICS = ["Recall(k=20)", "NDCG(k=20)"]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def small_cfg(**override) -> CFConfig:
    kw = dict(emb_dim=16, max_his=6, num_negs=4, batch_size=256, l_r=0.05,
              clip_val=0.1, seed=21, metrics=METRICS)
    kw.update(override)
    return CFConfig(**kw)


def engine(device="cpu", users=80, items=300, **override) -> Engine:
    train, test = synthetic_click_dataset(users, items, clicks_per_user=12,
                                          max_his=6, seed=9)
    return Engine(small_cfg(**override), train, test, device=device)


def assert_same_state(a: Engine, b: Engine, rtol=2e-6, atol=2e-7) -> None:
    for name in ("user_emb", "item_emb", "w0"):
        torch.testing.assert_close(
            getattr(a.state, name).float(), getattr(b.state, name).float(),
            rtol=rtol, atol=atol, msg=name)
    assert int(a.state.step) == int(b.state.step)
    assert int(a.sampler_state.iterations) == int(b.sampler_state.iterations)


# Each variant of the JAX package's train_epochs tests (tests/test_engine.py:
# 372-399 the default, 414-423 the tile sampler, 534 the fixed stream with
# the history dedup and accum), and Adam.
TRAIN_EPOCHS_VARIANTS = {
    "uniform": dict(milestones=[2]),
    "tile": dict(neg_sampler=1, tile_size=64, refresh_interval=512,
                 milestones=[2]),
    "fixed_dedup": dict(shuffle_mode="none", visit_order="user",
                        his_refresh="step", milestones=[2]),
    "once_accum": dict(shuffle_mode="once", sgd_mode="accum", milestones=[2]),
    "adam": dict(optimizer="adam", milestones=[2]),
    "pools_bf16_direct": dict(neg_sampler=1, tile_size=64, refresh_interval=512,
                              his_refresh="subepoch", update_mode="direct",
                              param_dtype="bfloat16", compute_dtype="bfloat16"),
}


@pytest.mark.parametrize("variant", list(TRAIN_EPOCHS_VARIANTS))
def test_train_epochs_matches_sequential(variant):
    """train_epochs(n) reproduces n sequential train_one_epoch calls: the
    same draws, LR schedule (milestone inside the window), losses and
    tables; interleaving keeps the streams aligned."""
    override = TRAIN_EPOCHS_VARIANTS[variant]
    e_seq, e_multi = engine(**override), engine(**override)
    if variant == "fixed_dedup":
        users, _, _ = e_multi._make_batches(e_multi.pairs)
        assert e_multi._history_dedup(e_multi.pairs, users) is not None
    seq = [e_seq.train_one_epoch() for _ in range(4)]
    multi = e_multi.train_epochs(4)
    np.testing.assert_allclose(multi, seq, rtol=1e-6)
    assert e_multi.epoch == e_seq.epoch == 4
    assert float(e_multi.state.lr) == float(e_seq.state.lr)
    assert_same_state(e_multi, e_seq)
    np.testing.assert_allclose(
        e_multi.train_epochs(2), [e_seq.train_one_epoch() for _ in range(2)],
        rtol=1e-6)
    assert_same_state(e_multi, e_seq)
    assert e_multi.train_epochs(0) == [] and e_multi.epoch == 6


def test_train_epochs_matches_the_jax_engine():
    """The port's train_epochs(3) against the JAX engine's (its one device
    program over the fixed stream), from one state with pinned negatives:
    the losses and tables agree as two epochs of the eager engines do
    (tests/test_torch_engine.py)."""
    from test_torch_engine import LR, _assert_tables_close, _engines
    from test_torch_step import pinned_negatives

    je, te = _engines(milestones=[1])
    draws = np.random.default_rng(3).integers(
        0, je.cfg.num_items,
        (3 * je.cfg.train_size + je.cfg.batch_size, je.cfg.num_negs),
    ).astype(np.int32)
    with pinned_negatives(draws):
        jl = je.train_epochs(3)
        tl = te.train_epochs(3)
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    assert tl[2] < tl[0]
    assert float(te.state.lr) == pytest.approx(float(je.state.lr))
    assert float(te.state.lr) < LR  # the milestone took
    _assert_tables_close(te, je)
    assert int(te.state.step) == int(je.state.step)


def test_reference_schedule_equals_the_original():
    from heat_tpu.train.run import reference_schedule as jschedule

    for epochs in range(0, 12):
        for interval in (1, 2, 3, 5):
            for start in (0, 1, 3, 4):
                assert reference_schedule(epochs, interval, start) == jschedule(
                    epochs, interval, start), (epochs, interval, start)


def test_run_epochs_with_eval_fused_matches_unfused():
    """Port of tests/test_engine.py:718-747: the fused run (train_epochs
    segments, on the card replays of the captured step) against the eager
    oracle: same losses, same metrics, evaluations after epochs 2 and 4."""
    e_fused, e_seq = engine(), engine()
    losses_f, evals_f = e_fused.run_epochs_with_eval(5, 2)
    losses_s, evals_s = e_seq.run_epochs_with_eval(5, 2, fused=False)
    assert len(losses_f) == len(losses_s) == 5
    np.testing.assert_allclose(losses_f, losses_s, rtol=1e-5)
    assert [ev["epoch"] for ev in evals_f] == [ev["epoch"] for ev in evals_s] == [2, 4]
    for ef, es in zip(evals_f, evals_s):
        assert list(ef) == ["epoch", *METRICS]
        for m in METRICS:
            np.testing.assert_allclose(ef[m], es[m], rtol=1e-5)
    assert e_fused.epoch == e_seq.epoch == 5
    assert_same_state(e_fused, e_seq, rtol=1e-5, atol=1e-7)
    # The same as the plain loop of epochs and evaluations.
    e_loop = engine()
    loop = [e_loop.train_one_epoch() for _ in range(3)]
    assert e_loop.evaluate() == {m: v for m, v in evals_f[0].items() if m != "epoch"}
    np.testing.assert_allclose(loop, losses_f[:3], rtol=1e-6)


def test_run_epochs_with_eval_resumed_schedule():
    """Port of tests/test_engine.py:686-716: a resumed run evaluates at the
    same absolute epochs as an uninterrupted one and matches its losses and
    metrics there."""
    assert reference_schedule(4, 2, start_epoch=3) == ((2, True), (2, True))
    assert reference_schedule(7, 2) == ((3, True), (2, True), (2, True))
    e_full = engine()
    losses_full, evals_full = e_full.run_epochs_with_eval(7, 2, metrics=METRICS[:1])
    assert [ev["epoch"] for ev in evals_full] == [2, 4, 6]
    e_res = engine()
    e_res.train_epochs(3)
    losses_f, evals_f = e_res.run_epochs_with_eval(4, 2, metrics=METRICS[:1])
    assert [ev["epoch"] for ev in evals_f] == [4, 6]
    e_res2 = engine()
    e_res2.train_epochs(3)
    losses_s, evals_s = e_res2.run_epochs_with_eval(4, 2, metrics=METRICS[:1],
                                                    fused=False)
    assert [ev["epoch"] for ev in evals_s] == [4, 6]
    np.testing.assert_allclose(losses_f, losses_s, rtol=1e-5)
    np.testing.assert_allclose(losses_f, losses_full[3:], rtol=1e-5)
    for ef, es, efull in zip(evals_f, evals_s, evals_full[1:]):
        np.testing.assert_allclose(ef[METRICS[0]], es[METRICS[0]], rtol=1e-5)
        np.testing.assert_allclose(ef[METRICS[0]], efull[METRICS[0]], rtol=1e-5)


# --- the in-place step ---------------------------------------------------

# One entry per branch of the step: sampler (uniform / tile), history (per
# step / pools / dedup), update (batch / accum / direct; dense and sorted),
# optimizer (SGD / Adagrad / Adam), type (f32 / bf16).
STEP_BRANCHES = {
    "uniform_step_batch_sgd_f32": {},
    "tile_step_batch_sgd_f32": dict(neg_sampler=1, tile_size=32,
                                    refresh_interval=256),
    "tile_pools_direct_sgd_bf16": dict(
        neg_sampler=1, tile_size=32, refresh_interval=256,
        his_refresh="subepoch", update_mode="direct",
        param_dtype="bfloat16", compute_dtype="bfloat16"),
    "uniform_dedup_batch_sgd_f32": dict(shuffle_mode="none", visit_order="user"),
    "uniform_step_accum_sgd_f32": dict(sgd_mode="accum"),
    "tile_step_accum_sgd_bf16": dict(neg_sampler=1, tile_size=32,
                                     refresh_interval=256, sgd_mode="accum",
                                     param_dtype="bfloat16",
                                     compute_dtype="bfloat16"),
    "uniform_step_batch_adagrad_f32": dict(optimizer="adagrad"),
    "tile_pools_batch_adam_f32": dict(neg_sampler=1, tile_size=32,
                                      refresh_interval=256,
                                      his_refresh="subepoch", optimizer="adam"),
    "uniform_step_batch_adam_bf16_sorted": dict(
        optimizer="adam", param_dtype="bfloat16", compute_dtype="bfloat16"),
    "uniform_step_direct_sgd_f32_sorted": dict(update_mode="direct", l2_enabled=True),
    "tile_step_batch_sgd_bf16_sorted": dict(neg_sampler=1, tile_size=32,
                                            refresh_interval=256,
                                            param_dtype="bfloat16",
                                            compute_dtype="bfloat16"),
}


def _tensors(state, sampler_state) -> dict:
    out = {name: getattr(state, name) for name in
           ("user_emb", "item_emb", "w0", "lr", "step", "user_gacc", "item_gacc")}
    out.update(state.opt_slots or {})
    out["iterations"] = sampler_state.iterations
    out["tile"] = sampler_state.tile
    return {k: v for k, v in out.items() if v is not None}


@pytest.mark.parametrize("branch", list(STEP_BRANCHES))
def test_step_updates_every_state_tensor_in_place(monkeypatch, branch):
    """After a step the state, the sampler state and each of their tensors
    (w0, step, the w0 slots, iterations and tile among them) are the objects
    passed, at the same addresses, and they moved: what a captured step,
    replayed against its capture's addresses, needs. Then the engine keeps
    its state's tensors and stream buffers across epochs, and takes a pools
    buffer of its own each epoch (dropped over the shuffle)."""
    if branch.endswith("_sorted"):
        import heat_tpu_torch.train.scatter as tsc

        monkeypatch.setattr(tsc, "DENSE_ROWS_THRESHOLD", 16)
    cfg = small_cfg(num_users=40, num_items=90, batch_size=48,
                    **STEP_BRANCHES[branch])
    rng = np.random.default_rng(1)
    users = torch.from_numpy(rng.integers(0, 40, 48).astype(np.int32))
    pos = torch.from_numpy(rng.integers(0, 90, 48).astype(np.int32))
    weight = torch.ones(48)
    weight[-5:] = 0.0
    his = torch.from_numpy(rng.integers(0, 90, (40, 6)).astype(np.int32))
    masks = torch.from_numpy(rng.integers(0, 7, 40).astype(np.int32))
    g = torch.Generator().manual_seed(0)
    state = init_train_state(cfg, g, "cpu")
    sstate = init_sampler_state(cfg, "cpu", g)
    before = _tensors(state, sstate)
    ptrs = {k: v.data_ptr() for k, v in before.items()}
    values = {k: v.clone() for k, v in before.items()}
    means = uniq = inv = None
    if cfg.his_refresh == "subepoch":
        means = user_pools_impl(state.item_emb, his, masks)
    if cfg.shuffle_mode == "none":
        u, inverse = torch.unique(users, return_inverse=True)
        uniq, inv = u.to(torch.int32), inverse.to(torch.int32)
    for _ in range(2):
        new_state, new_sstate, loss = tts.train_step(
            state, sstate, g, tts.Batch(users, pos, weight), his, masks, cfg,
            user_means=means, uniq_users=uniq, uniq_inverse=inv)
        assert new_state is state and new_sstate is sstate
        assert torch.isfinite(loss)
    after = _tensors(state, sstate)
    assert after.keys() == before.keys()
    for name, t in after.items():
        assert t is before[name] and t.data_ptr() == ptrs[name], name
    assert int(state.step) == 2 and int(sstate.iterations) == 2 * 43
    moved = [k for k in after if not torch.equal(after[k], values[k])]
    assert {"user_emb", "item_emb", "w0", "step", "iterations"} <= set(moved)
    for slot in ("w0_m", "w0_v"):
        if slot in after:
            assert slot in moved

    # The engine: the same tensors and buffers epoch after epoch.
    e = engine(**STEP_BRANCHES[branch])
    e.train_one_epoch()
    held = {k: v.data_ptr() for k, v in _tensors(e.state, e.sampler_state).items()}
    pools = e._pools
    stream = [t.data_ptr() for t in e._make_batches(e.pairs)]
    assert e._pools is None  # dropped over the shuffle
    e.train_epochs(2)
    assert held == {k: v.data_ptr()
                    for k, v in _tensors(e.state, e.sampler_state).items()}
    assert (pools is None) == (cfg.his_refresh != "subepoch")
    if pools is not None:
        assert e._pools is not pools
        assert e._pools.shape == pools.shape and e._pools.dtype == e.state.item_emb.dtype
    assert stream == [t.data_ptr() for t in e._make_batches(e.pairs)]


def test_epoch_fn_runs_any_slice_of_the_stream():
    """make_epoch_fn's (first, count) slices compose into the whole epoch:
    the entry ``bench_large --profile`` times the steps through; a captured
    epoch function needs CUDA tensors."""
    a, b = engine(batch_size=64), engine(batch_size=64)
    users, pos, weight = a._make_batches(a.pairs)
    b._make_batches(b.pairs)
    nb = users.shape[0]
    assert nb > 3
    args = (users, pos, weight, a.his_items, a.his_masks)
    fn = tts.make_epoch_fn(a.cfg, capture=False)
    _, _, whole = fn(a.state, a.sampler_state, a.generator, *args)
    fn_b = tts.make_epoch_fn(b.cfg, capture=False)
    parts = [fn_b(b.state, b.sampler_state, b.generator, *args,
                  first=f, count=c)[2] for f, c in ((0, 1), (1, 2), (3, nb - 3))]
    assert float(whole) == pytest.approx(float(sum(parts)), rel=1e-6)
    assert torch.equal(a.state.item_emb, b.state.item_emb)
    assert int(a.state.step) == int(b.state.step) == nb
    with pytest.raises(ValueError, match="outside"):
        fn(a.state, a.sampler_state, a.generator, *args, first=nb - 1, count=2)
    with pytest.raises(ValueError, match="CUDA"):
        tts.make_epoch_fn(a.cfg, capture=True)(
            a.state, a.sampler_state, a.generator, *args)


def test_profile_reports_both_forms_on_the_cpu():
    """bench_large --profile: the eager form's numbers at the top level and
    under "eager"; no replayed form and no device number on the CPU."""
    record = bench_large.run([
        "--device", "cpu", "--users", "300", "--items", "200", "--clicks",
        "1500", "--dim", "16", "--max-his", "10", "--batch", "256", "--reps",
        "1", "--profile", "2"])
    prof = record["profile"]
    assert prof["replayed"] is None
    assert prof["eager"]["wall_ms_per_step"] == prof["wall_ms_per_step"] > 0
    assert prof["eager"]["device_ms_per_step"] is None
    assert prof["eager"]["port_kernels_per_step"] is None
    # On the CPU the wrappers run their plain versions and count nothing.
    assert prof["eager"]["wrapper_launches_per_step"] == dict.fromkeys(
        bench_large.KERNEL_FAMILIES, 0.0)
    assert record["captures"] is None


def test_kernel_families_name_every_port_kernel():
    """The trace's families of bench_large.KERNEL_FAMILIES: each kernel
    name is a __global__ kernel of csrc/, every kernel there has a family,
    each wrapper is a launch counter, and a trace event's name maps back
    (templated, in a namespace) while PyTorch's own kernels map to none."""
    csrc = Path(bench_large.__file__).parent / "csrc"
    declared = set()
    for src in csrc.glob("*.cu"):
        declared |= set(re.findall(
            r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)",
            src.read_text()))
    families = bench_large.KERNEL_FAMILIES
    named = {k for kernels, _ in families.values() for k in kernels}
    assert named == declared
    counters = {**gather.LAUNCHES, **scatter.LAUNCHES, **topk.LAUNCHES}
    wrappers = {w for _, ws in families.values() for w in ws}
    assert wrappers == {w for w in counters if not w.endswith("_bf16")}
    assert bench_large.kernel_family(
        "void (anonymous namespace)::history_mean_kernel<float, float, 4, 2>"
        "(Vec<float, 4> const*, int const*)") == "K1"
    assert bench_large.kernel_family("gather_rows_multi_kernel(MultiArgs)") == "K2_multi"
    assert bench_large.kernel_family("void gather_rows_kernel<float4>(...)") == "K2"
    assert bench_large.kernel_family("scatter_copy_kernel<float4>") == "S1"
    assert bench_large.kernel_family(
        "void at::native::vectorized_elementwise_kernel<4, at::native::"
        "CUDAFunctor_add<float>>") is None


def test_distinct_id_dataset_repeats_no_id_in_any_batch():
    """The dataset of the bit-equal replay check: every user and every
    clicked item once, so that no shuffled batch repeats either."""
    data = distinct_id_dataset(48, 1000, 6, seed=3)
    assert data.train_size == data.num_users == 48
    assert len(np.unique(data.pairs[:, 0])) == 48
    assert len(np.unique(data.pairs[:, 1])) == 48
    assert data.pairs[:, 1].max() < 1000
    assert ((data.masks >= 1) & (data.masks <= 6)).all()
    e = Engine(small_cfg(batch_size=16, max_his=6), data, device="cpu")
    users, pos, _ = e._make_batches(e.pairs)
    for b in range(users.shape[0]):
        assert torch.unique(users[b]).numel() == torch.unique(pos[b]).numel() == 16


# --- the CLI ----------------------------------------------------------------


def _cli_lines(capsys, *flags):
    record = tmain.main(["--config", CONFIG0, "--synthetic", "200,400",
                         "--epochs", "5", "--device", "cpu", *flags])
    out = capsys.readouterr().out.strip().splitlines()
    # Everything but the epoch times: losses, metric lines, final metrics.
    lines = [line.split("; epoch_time:")[0] for line in out]
    return lines, record


def test_cli_fused_flags_print_the_plain_runs_lines(capsys):
    plain, rec = _cli_lines(capsys)
    assert sum(line.startswith("epoch: ") for line in plain) == 5
    assert sum(line.startswith("[Metrics] ") for line in plain) == 2  # epochs 2, 4
    for flags in (["--fused-epochs", "3"], ["--fused-run"]):
        lines, fused = _cli_lines(capsys, *flags)
        assert lines == plain, flags
        assert set(fused) == set(rec)
        assert fused["losses"] == rec["losses"]
        assert [e["epoch"] for e in fused["evals"]] == [2, 4]
        assert [e["metrics"] for e in fused["evals"]] == [
            e["metrics"] for e in rec["evals"]]
        assert fused["steps"] == rec["steps"]
        times = fused["epoch_times"]
        if flags[0] == "--fused-run":  # one average
            assert len(set(times)) == 1
            assert [e["seconds"] for e in fused["evals"]] == [None, None]
        else:  # eval_interval 2: the chunks [0, 2] and [3, 4]
            assert times[0] == times[1] == times[2] and times[3] == times[4]
    assert json.loads(plain[-1])["final_metrics"] == rec["final_metrics"]


# --- on the card --------------------------------------------------------------


def _recorded_run(device, capture, epochs=2, **override):
    e = engine(device, **override)
    e._capture = capture
    nb = -(-e.cfg.train_size // e.cfg.batch_size)
    rec = StepRecorder(epochs * nb, e.cfg.batch_size, e.cfg.num_negs,
                       e.cfg.tile_size if e.cfg.neg_sampler == 1 else 0,
                       device, True)
    with rec:
        losses = e.train_epochs(epochs)
    torch.cuda.synchronize()
    return e, rec, losses


@pytest.mark.cuda
@pytest.mark.parametrize("override", [
    {}, dict(neg_sampler=1, tile_size=32, refresh_interval=256,
             his_refresh="subepoch", update_mode="direct",
             param_dtype="bfloat16", compute_dtype="bfloat16"),
], ids=["config0_shape", "headline_shape"])
def test_replayed_draws_equal_eager_draws(cuda, override):
    """Two epochs, an eager shuffle between them: every replayed step draws
    the negatives, tile and tile indices of the eager step from the same
    seed, and the counters end equal; the capture adds no step and leaves
    the generator where the eager run leaves it."""
    eager, rec_e, _ = _recorded_run(cuda, False, **override)
    fused, rec_f, _ = _recorded_run(cuda, True, **override)
    assert int(rec_e.count) == int(rec_f.count) == rec_e.ids.shape[0]
    for name in ("ids", "idx", "tiles"):
        assert torch.equal(getattr(rec_e, name), getattr(rec_f, name)), name
    assert int(eager.state.step) == int(fused.state.step)
    assert int(eager.sampler_state.iterations) == int(fused.sampler_state.iterations)
    assert torch.equal(eager.generator.get_state(), fused.generator.get_state())


@pytest.mark.cuda
def test_capture_trains_nothing_of_its_own(cuda):
    """The warm-up is the epoch's first step, so an epoch that captures
    takes nb steps, like the eager epoch and like an epoch that only
    replays; the state's tensors keep their addresses."""
    e = engine(cuda)
    nb = -(-e.cfg.train_size // e.cfg.batch_size)
    held = {k: v.data_ptr() for k, v in _tensors(e.state, e.sampler_state).items()}
    e.train_one_epoch()  # captures
    assert int(e.state.step) == nb
    graph = e._epoch_fns[True]._graph
    assert graph is not None
    e.train_one_epoch()  # replays only
    assert e._epoch_fns[True]._graph is graph
    assert int(e.state.step) == 2 * nb
    assert held == {k: v.data_ptr()
                    for k, v in _tensors(e.state, e.sampler_state).items()}


@pytest.mark.cuda
def test_a_new_state_is_captured_again(cuda):
    e = engine(cuda)
    e.train_one_epoch()
    fn = e._epoch_fns[True]
    graph = fn._graph
    old = e.state
    kept = old.item_emb.clone()
    e.state = init_train_state(e.cfg, torch.Generator(cuda).manual_seed(5), cuda)
    e.train_one_epoch()
    assert fn._graph is not graph
    assert torch.equal(old.item_emb, kept)  # the old tables are not written
    assert int(e.state.step) == -(-e.cfg.train_size // e.cfg.batch_size)


@pytest.mark.cuda
def test_replays_call_no_wrapper_and_the_trace_counts_their_kernels(cuda):
    """The wrappers count where they launch: the capture's warm-up step and
    the capture itself; a replay calls none. A device trace of a replayed
    epoch sees each of the step's kernels once a step."""
    from torch.profiler import ProfilerActivity, profile

    e = engine(cuda)
    nb = -(-e.cfg.train_size // e.cfg.batch_size)
    for counters in (gather.LAUNCHES, scatter.LAUNCHES, topk.LAUNCHES):
        for name in counters:
            counters[name] = 0
    e.train_one_epoch()  # the warm-up step, the capture, nb - 1 replays
    assert gather.LAUNCHES["gather_rows_multi"] == 2
    assert gather.LAUNCHES["history_mean_gather"] == 2
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        e.train_one_epoch()  # replays only
        torch.cuda.synchronize()
    assert gather.LAUNCHES["gather_rows_multi"] == 2
    seen = dict.fromkeys(bench_large.KERNEL_FAMILIES, 0)
    for event in prof.key_averages():
        fam = bench_large.kernel_family(event.key)
        if fam is not None and event.device_type.name == "CUDA":
            seen[fam] += event.count
    assert seen["K2_multi"] == seen["K1"] == nb
    assert seen["K3"] >= nb and seen["S1"] >= nb


@pytest.mark.cuda
@pytest.mark.parametrize("override", [
    {}, dict(neg_sampler=1, tile_size=16, refresh_interval=32,
             his_refresh="subepoch", update_mode="direct",
             param_dtype="bfloat16", compute_dtype="bfloat16"),
], ids=["config0_shape", "headline_shape"])
def test_replayed_epochs_are_bit_equal_where_the_step_is_deterministic(
        cuda, override):
    """On clicks that repeat no user and no item, with 4,000,000 items (no
    row takes two adds in a step, so K3's atomics add in a fixed order):
    two epochs of three steps, replayed, equal two eager epochs bit for
    bit after each epoch, the pool refresh and shuffle between them."""
    data = distinct_id_dataset(48, 4_000_000, 6)
    cfg = dict(batch_size=16, num_negs=2, **override)
    out = replayed_equals_eager(
        lambda: Engine(small_cfg(**cfg), data, device=cuda), 2)
    assert out["steps"] == 6


@pytest.mark.cuda
def test_a_step_that_fails_during_capture_raises(monkeypatch, cuda):
    e = engine(cuda)
    orig = tts.sample_negatives

    def failing(*args, **kw):
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("refused during capture")
        return orig(*args, **kw)

    monkeypatch.setattr(tts, "sample_negatives", failing)
    with pytest.raises(RuntimeError, match="refused during capture"):
        e.train_one_epoch()
    assert e._epoch_fns[True]._graph is None
