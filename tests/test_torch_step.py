"""One training step of the port against the JAX package's.

Both packages start from one state (the JAX initial state carried over by
``state_from_numpy``), see one batch with repeated users and items and a
weight-0 tail, and draw the same negatives: each side's
``sample_negatives`` is replaced by a lookup into one precomputed draw
table, indexed by the sampler's sample counter (the pinning of
tests/test_trajectory_parity.py). Results agree to rtol 1e-5 / atol 1e-7:
the two packages sum in different orders. The update menu's branches
(sort-dedup forced by lowering ``DENSE_ROWS_THRESHOLD`` in both packages,
direct, l2, Adagrad, Adam, accum) go through the same harness.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import heat_tpu.train.scatter as jsc
import heat_tpu.train.train_step as jts
import heat_tpu_torch.train.scatter as tsc
import heat_tpu_torch.train.train_step as tts
from heat_tpu.config import CFConfig as JCFConfig
from heat_tpu.models.state import init_train_state as jinit
from heat_tpu.train.samplers import NegSample as JNegSample
from heat_tpu.train.samplers import init_sampler_state as jinit_sampler
from heat_tpu.train.scatter import apply_row_updates as japply
from heat_tpu_torch.config import CFConfig
from heat_tpu_torch.models.state import state_from_numpy, state_to_numpy
from heat_tpu_torch.testing import (
    Order,
    assert_state_array_close,
    hold_by_order_spread,
)
from heat_tpu_torch.train.samplers import NegSample as TNegSample
from heat_tpu_torch.train.samplers import SamplerState, init_sampler_state
from heat_tpu_torch.train.scatter import apply_row_updates as tapply

TOL = dict(rtol=1e-5, atol=1e-7)


@contextlib.contextmanager
def pinned_negatives(draws: np.ndarray, perm=None):
    """Both packages' samplers return draws[counter : counter + B]; the
    port's in the order ``perm`` (a permutation of the batch's samples, to
    go with a batch permuted alike) when one is given."""
    jtable, ttable = jnp.asarray(draws), torch.from_numpy(draws)
    order = None if perm is None else torch.as_tensor(perm)

    def jpinned(key, sstate, pos_ids, cfg, real=None):
        idx = sstate.iterations + jnp.arange(pos_ids.shape[0], dtype=jnp.int32)
        adv = pos_ids.shape[0] if real is None else real
        return JNegSample(jtable[idx], None, None), sstate.replace(
            iterations=sstate.iterations + adv
        )

    def tpinned(generator, sstate, pos_ids, cfg, real=None):
        it = int(sstate.iterations)
        adv = pos_ids.shape[0] if real is None else real
        rows = ttable[it : it + pos_ids.shape[0]]
        if order is not None:
            rows = rows.index_select(0, order)
        return TNegSample(rows.to(pos_ids.device)), (
            SamplerState(iterations=sstate.iterations + adv)
        )

    jorig, torig = jts.sample_negatives, tts.sample_negatives
    jts.sample_negatives, tts.sample_negatives = jpinned, tpinned
    try:
        yield
    finally:
        jts.sample_negatives, tts.sample_negatives = jorig, torig


def _setup(lr, clip_val, seed=0, u=40, i=90, h=8, b=48, k=4, d=16, **extra):
    rng = np.random.default_rng(seed)
    kw = dict(emb_dim=d, num_users=u, num_items=i, max_his=h, num_negs=k,
              batch_size=b, l_r=lr, clip_val=clip_val, seed=seed, **extra)
    jcfg, tcfg = JCFConfig(**kw), CFConfig(**kw)
    users = rng.integers(0, u, b).astype(np.int32)
    pos = rng.integers(0, i, b).astype(np.int32)
    users[:6] = 3  # repeated user
    pos[6:12] = 5  # repeated item
    weight = np.ones(b, np.float32)
    weight[-7:] = 0.0  # weight-0 padding tail, repeating real pairs
    users[-7:], pos[-7:] = users[:7], pos[:7]
    his = rng.integers(0, i, (u, h)).astype(np.int32)
    masks = rng.integers(0, h + 1, u).astype(np.int32)
    masks[3] = 0  # the repeated user has an empty history
    draws = rng.integers(0, i, (4 * b, k)).astype(np.int32)
    draws[:3, 0] = 5  # negatives that repeat the repeated positive
    # Rows for the accum steps past the fourth batch.
    more = rng.integers(0, i, (ACCUM_STEPS * b, k)).astype(np.int32)
    draws = np.concatenate([draws, more])
    return jcfg, tcfg, (users, pos, weight), his, masks, draws


# The clip binds on most elements at clip_val 0.02; at 1e9 it never does,
# so every gradient element reaches the tables (lr keeps the step small).
@pytest.mark.parametrize("lr,clip_val", [(0.05, 0.02), (1e-4, 1e9)])
def test_train_step_matches_jax(lr, clip_val):
    jcfg, tcfg, (users, pos, weight), his, masks, draws = _setup(lr, clip_val)
    jstate = jinit(jcfg, jax.random.key(1))
    tstate = state_from_numpy(
        jstate.user_emb, jstate.item_emb, jstate.w0,
        lr=jcfg.l_r, step=0, device="cpu",
    )
    jbatch = jts.Batch(*map(jnp.asarray, (users, pos, weight)))
    tbatch = tts.Batch(*map(torch.from_numpy, (users, pos, weight)))
    with pinned_negatives(draws):
        jss = jinit_sampler(jcfg, jax.random.key(2))
        tss = init_sampler_state(tcfg, "cpu")
        for _ in range(2):  # the second step reads the first one's writes
            jstate, jss, jloss = jts.train_step(
                jstate, jss, jax.random.key(3), jbatch,
                jnp.asarray(his), jnp.asarray(masks), jcfg,
            )
            tstate, tss, tloss = tts.train_step(
                tstate, tss, torch.Generator(), tbatch,
                torch.from_numpy(his), torch.from_numpy(masks), tcfg,
            )
            np.testing.assert_allclose(float(tloss), float(jloss), **TOL)
    got = state_to_numpy(tstate)
    for name in ("user_emb", "item_emb", "w0"):
        np.testing.assert_allclose(
            got[name], np.asarray(getattr(jstate, name)), err_msg=name, **TOL
        )
    assert int(got["step"]) == int(jstate.step) == 2
    assert int(tss.iterations) == int(jss.iterations) == 2 * 41
    # Rows the batch never touched are unchanged on both sides.
    untouched = np.setdiff1d(np.arange(40), users[:-7])
    np.testing.assert_array_equal(
        got["user_emb"][untouched], np.asarray(jinit(jcfg, jax.random.key(1)).user_emb)[untouched]
    )


def test_apply_row_updates_with_writeback_matches_jax():
    """Dense path: write-back first, then clip(sum per row) SGD; repeated
    ids combine before the clip and sentinel ids (== N) touch nothing."""
    rng = np.random.default_rng(7)
    n, d, m = 30, 16, 64
    table = rng.normal(size=(n, d)).astype(np.float32)
    ids = rng.integers(0, n, m).astype(np.int32)
    ids[:5] = 4
    ids[-6:] = n  # padding
    grads = rng.normal(size=(m, d)).astype(np.float32)
    wb = rng.normal(size=(m, d)).astype(np.float32)
    wb[1:5] = wb[0]  # repeated ids write identical rows
    wb[-6:] = 99.0  # padding rows must never land
    want = japply(
        jnp.asarray(table), jnp.asarray(ids), jnp.asarray(grads),
        lr=jnp.float32(0.1), clip_val=0.5, writeback=jnp.asarray(wb),
    )[0]
    got, _ = tapply(
        torch.from_numpy(table.copy()), torch.from_numpy(ids),
        torch.from_numpy(grads), lr=torch.tensor(0.1), clip_val=0.5,
        writeback=torch.from_numpy(wb),
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert np.abs(got.numpy()).max() < 50


def torch_state_of(jstate, device="cpu"):
    """The port's copy of a JAX TrainState, gradient rows, slots and
    ``attn_q`` included."""
    def arr(x):
        return None if x is None else np.asarray(x)

    return state_from_numpy(
        jstate.user_emb, jstate.item_emb, jstate.w0, lr=float(jstate.lr),
        step=int(jstate.step), device=device,
        user_gacc=arr(jstate.user_gacc), item_gacc=arr(jstate.item_gacc),
        opt_slots=None if jstate.opt_slots is None else {
            k: np.asarray(v) for k, v in jstate.opt_slots.items()
        },
        attn_q=arr(jstate.attn_q),
    )


L2 = dict(l2_enabled=True, l2=0.01)


def snapshot(tstate) -> dict:
    """``state_to_numpy`` of the port's state, copied: its arrays are views
    of the tensors, which the next step updates in place."""
    return {k: ({n: a.copy() for n, a in v.items()} if isinstance(v, dict)
                else np.array(v, copy=True))
            for k, v in state_to_numpy(tstate).items()}


# Accum mode is held to the JAX step for ACCUM_STEPS steps: steps 1-2 by
# assert_state_array_close's cap, steps 3 on by the spread rule
# (heat_tpu_torch.testing.assert_within_order_spread) against PERMUTATIONS
# runs of the port with the batch's samples permuted.
ACCUM_STEPS = 8
PERMUTATIONS = 5


def port_steps(tcfg, jstate0, batch, his, masks, draws, steps, n=0):
    """``steps`` steps of the port from the JAX initial state on one batch,
    its sums in :class:`Order` ``n``: each step's loss and state (numpy,
    in the given order)."""
    d = jstate0.w0.shape[0]
    order = Order(n, batch[0].shape[0], draws.shape[1], d)
    arrays = [x[order.samples] for x in batch]
    init = order.state({k: None if getattr(jstate0, k) is None
                        else np.asarray(getattr(jstate0, k))
                        for k in ("user_emb", "item_emb", "w0", "user_gacc",
                                  "item_gacc")})
    tstate = state_from_numpy(
        init["user_emb"], init["item_emb"], init["w0"], lr=float(jstate0.lr),
        step=int(jstate0.step), device="cpu", user_gacc=init["user_gacc"],
        item_gacc=init["item_gacc"])
    tss = init_sampler_state(tcfg, "cpu")
    losses, states = [], []
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # ops of a few KB: no thread pool to wait on
    try:
        with pinned_negatives(np.ascontiguousarray(draws[:, order.negs]),
                              order.samples):
            for _ in range(steps):
                tstate, tss, tloss = tts.train_step(
                    tstate, tss, torch.Generator(),
                    tts.Batch(*map(torch.from_numpy, arrays)),
                    torch.from_numpy(his), torch.from_numpy(masks), tcfg,
                )
                losses.append(float(tloss))
                states.append(order.restore(snapshot(tstate)))
    finally:
        torch.set_num_threads(threads)
    return losses, states


def jax_steps(jcfg, jstate0, batch, his, masks, draws, steps):
    """The JAX step's losses and states (the port's numpy form) over
    ``steps`` steps on one batch, the draws pinned."""
    jstate, losses, states = jstate0, [], []
    with pinned_negatives(draws):
        jss = jinit_sampler(jcfg, jax.random.key(2))
        for _ in range(steps):
            jstate, jss, jloss = jts.train_step(
                jstate, jss, jax.random.key(3),
                jts.Batch(*map(jnp.asarray, batch)),
                jnp.asarray(his), jnp.asarray(masks), jcfg,
            )
            losses.append(float(jloss))
            states.append(state_to_numpy(torch_state_of(jstate)))
    return losses, states


@pytest.mark.parametrize("sort,extra", [
    (True, {}),
    (False, {"update_mode": "direct"}),
    (False, {"update_mode": "direct", **L2}),
    (False, L2),
    (True, L2),
    (False, {"optimizer": "adagrad"}),
    (True, {"optimizer": "adagrad", **L2}),
    (False, {"optimizer": "adam"}),
    (True, {"optimizer": "adam"}),
    (False, {"sgd_mode": "accum"}),
    (True, {"sgd_mode": "accum"}),
], ids=["sorted", "direct", "direct-l2", "l2", "sorted-l2", "adagrad",
        "sorted-adagrad-l2", "adam", "sorted-adam", "accum", "sorted-accum"])
def test_train_step_branches_match_jax(monkeypatch, sort, extra):
    """Two steps (the second reads the first's tables, slots and gradient
    rows), then a third on an all-padding batch, which must change
    nothing but the sampler. Losses agree to rtol 1e-5. State arrays:
    rtol 1e-5 / atol 1e-7 on at least 99.5% of the elements, and nowhere
    off by more than 1e-4 * lr (tables, w0) or 1e-3 * clip_val (gradient
    rows and slots, which hold gradients). Adagrad and Adam divide a
    combined gradient by its own norm, so where that gradient is near
    zero the summation-order noise of a few ulps grows (measured: one
    table element in 640-1440 off by up to 2.9e-6); accum rows sum
    per-occurrence gradients of ~1e2 that cancel (measured: one element
    off by 1.5e-5). A wrong update moves a row by ~lr * clip_val = 1e-3
    (SGD) or ~lr (Adam), a wrong accumulation by ~clip_val.

    Accum mode runs ACCUM_STEPS = 8 steps before the padding batch: after
    step 2 the state is held by that rule, and from step 3 on, where a
    repeated user's cancelling gradients leave its cap on one card as on
    a mesh, every state array and the loss by the spread rule
    (``assert_within_order_spread``): within SPREAD_MULTIPLE = 4 times the
    largest difference among the port's own runs under orders that change
    nothing but summation (PERMUTATIONS = 5 runs with the batch's samples
    and their pinned draws permuted, and the run as given), at every
    element. The JAX package's order is one more such order; 4x leaves
    room for the packages' other association of the same sums (a factor
    applied before or after a product), while a wrong accumulation moves
    a row by ~clip_val (``test_accum_spread_rule_catches_a_wrong_accumulation``).
    The multiple was stated before the first measurement."""
    if sort:  # both tables (40 and 90 rows) on the sort-dedup path
        monkeypatch.setattr(jsc, "DENSE_ROWS_THRESHOLD", 16)
        monkeypatch.setattr(tsc, "DENSE_ROWS_THRESHOLD", 16)
    jcfg, tcfg, (users, pos, weight), his, masks, draws = _setup(
        0.05, 0.02, **extra
    )
    accum = extra.get("sgd_mode") == "accum"
    steps = ACCUM_STEPS if accum else 2
    jstate0 = jinit(jcfg, jax.random.key(1))
    jstate = jstate0
    tstate = torch_state_of(jstate)
    pad = np.zeros_like(weight)
    batches = [(users, pos, weight)] * steps + [(users, pos, pad)]
    tlosses, tstates, jlosses, jstates = [], [], [], []
    with pinned_negatives(draws):
        jss = jinit_sampler(jcfg, jax.random.key(2))
        tss = init_sampler_state(tcfg, "cpu")
        for n, arrays in enumerate(batches):
            jstate, jss, jloss = jts.train_step(
                jstate, jss, jax.random.key(3),
                jts.Batch(*map(jnp.asarray, arrays)),
                jnp.asarray(his), jnp.asarray(masks), jcfg,
            )
            before = snapshot(tstate)
            tstate, tss, tloss = tts.train_step(
                tstate, tss, torch.Generator(),
                tts.Batch(*map(torch.from_numpy, arrays)),
                torch.from_numpy(his), torch.from_numpy(masks), tcfg,
            )
            if n < 2:
                np.testing.assert_allclose(float(tloss), float(jloss), **TOL)
            tlosses.append(float(tloss))
            jlosses.append(float(jloss))
            tstates.append(snapshot(tstate))
            jstates.append(state_to_numpy(torch_state_of(jstate)))
    after = state_to_numpy(tstate)
    want = state_to_numpy(torch_state_of(jstate))
    assert set(after) == set(want)

    def close(got, exp, name):
        assert_state_array_close(got, exp, name, lr=jcfg.l_r,
                                 clip_val=jcfg.clip_val, **TOL)

    # After step 2: the cap rule, as before.
    two, jtwo = dict(tstates[1]), dict(jstates[1])
    for slot, got in two.pop("opt_slots", {}).items():
        close(got, jtwo["opt_slots"][slot], slot)
    for name, got in two.items():
        close(got, jtwo[name], name)
    if accum:
        runs = [(tlosses[:steps], tstates[:steps])] + [
            port_steps(tcfg, jstate0, (users, pos, weight), his, masks, draws,
                       steps, n)
            for n in range(1, PERMUTATIONS + 1)]
        hold_by_order_spread(runs, (jlosses[:steps], jstates[:steps]))
    # The padding batch: no change but the sampler's.
    np.testing.assert_allclose(tlosses[-1], jlosses[-1], **TOL)
    slots = after.pop("opt_slots", {})
    for slot, got in slots.items():
        np.testing.assert_array_equal(got, before["opt_slots"][slot])
    for name, got in after.items():
        if name not in ("lr", "step"):
            np.testing.assert_array_equal(got, before[name], err_msg=name)
    assert set(slots) == set(want.get("opt_slots", {}))
    assert int(after["step"]) == int(jstate.step) == steps


def _drop_user_decay(orig):
    def plant(*args, **kw):  # the user rows' accum not decayed by gamma
        return orig(*args, **dict(kw, decay=1.0))
    return "apply_row_updates", plant


def _drop_stale_term(orig):
    def plant(user_gacc, users, means, weight, gamma):
        d = means.shape[1]
        return torch.zeros((d, d), dtype=torch.float32)
    return "stale_w0_term", plant


def _clip_before_sum(orig):
    def plant(table, ids, grads, **kw):  # each occurrence clipped, then summed
        clip = kw["clip_val"]
        return orig(table, ids, grads.clamp(-clip, clip), **kw)
    return "apply_row_updates", plant


PLANTED = {"user_rows_not_decayed": _drop_user_decay,
           "stale_term_dropped": _drop_stale_term,
           "clip_before_the_sum": _clip_before_sum}


# The planted faults run to step PLANTED_STEPS: the rule holds steps 3 on.
PLANTED_STEPS = 4


@pytest.fixture(scope="module")
def accum_jax_steps():
    """The JAX step's first PLANTED_STEPS accum steps on ``_setup``'s
    batch (the dense path), computed once for the planted faults."""
    jcfg, tcfg, batch, his, masks, draws = _setup(0.05, 0.02, sgd_mode="accum")
    jstate0 = jinit(jcfg, jax.random.key(1))
    return (tcfg, jstate0, batch, his, masks, draws,
            jax_steps(jcfg, jstate0, batch, his, masks, draws, PLANTED_STEPS))


@pytest.mark.parametrize("fault", sorted(PLANTED))
def test_accum_spread_rule_catches_a_wrong_accumulation(
        monkeypatch, accum_jax_steps, fault):
    """The spread rule of the accum steps (``hold_by_order_spread``, steps
    3 on) fails a port with a planted fault of its accumulation: the user
    rows' accum not decayed by gamma, the stale term of ``w0``'s gradient
    dropped, or each occurrence clipped before the sum. Its spread is
    taken from the faulty port's own reordered runs, as the rule takes it
    from a port under test. (The port as it is passes the rule on these
    steps and on to step 8: ``test_train_step_branches_match_jax``.)"""
    tcfg, jstate0, batch, his, masks, draws, want = accum_jax_steps
    name, plant = PLANTED[fault](getattr(tts, {
        "stale_term_dropped": "stale_w0_term"}.get(fault, "apply_row_updates")))
    monkeypatch.setattr(tts, name, plant)
    runs = [port_steps(tcfg, jstate0, batch, his, masks, draws,
                       PLANTED_STEPS, n) for n in range(PERMUTATIONS + 1)]
    with pytest.raises(AssertionError, match="order spread"):
        hold_by_order_spread(runs, want)
