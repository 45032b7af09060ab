"""One training step of the port against the JAX package's.

Both packages start from one state (the JAX initial state carried over by
``state_from_numpy``), see one batch with repeated users and items and a
weight-0 tail, and draw the same negatives: each side's
``sample_negatives`` is replaced by a lookup into one precomputed draw
table, indexed by the sampler's sample counter (the pinning of
tests/test_trajectory_parity.py). Results agree to rtol 1e-5 / atol 1e-7:
the two packages sum in different orders.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import heat_tpu.train.train_step as jts
import heat_tpu_torch.train.train_step as tts
from heat_tpu.config import CFConfig as JCFConfig
from heat_tpu.models.state import init_train_state as jinit
from heat_tpu.train.samplers import NegSample as JNegSample
from heat_tpu.train.samplers import init_sampler_state as jinit_sampler
from heat_tpu.train.scatter import apply_row_updates as japply
from heat_tpu_torch.config import CFConfig
from heat_tpu_torch.models.state import state_from_numpy, state_to_numpy
from heat_tpu_torch.train.samplers import NegSample as TNegSample
from heat_tpu_torch.train.samplers import SamplerState, init_sampler_state
from heat_tpu_torch.train.scatter import apply_row_updates as tapply

TOL = dict(rtol=1e-5, atol=1e-7)


@contextlib.contextmanager
def pinned_negatives(draws: np.ndarray):
    """Both packages' samplers return draws[counter : counter + B]."""
    jtable, ttable = jnp.asarray(draws), torch.from_numpy(draws)

    def jpinned(key, sstate, pos_ids, cfg, real=None):
        idx = sstate.iterations + jnp.arange(pos_ids.shape[0], dtype=jnp.int32)
        adv = pos_ids.shape[0] if real is None else real
        return JNegSample(jtable[idx], None, None), sstate.replace(
            iterations=sstate.iterations + adv
        )

    def tpinned(generator, sstate, pos_ids, cfg, real=None):
        it = int(sstate.iterations)
        adv = pos_ids.shape[0] if real is None else real
        return TNegSample(ttable[it : it + pos_ids.shape[0]].to(pos_ids.device)), (
            SamplerState(iterations=sstate.iterations + adv)
        )

    jorig, torig = jts.sample_negatives, tts.sample_negatives
    jts.sample_negatives, tts.sample_negatives = jpinned, tpinned
    try:
        yield
    finally:
        jts.sample_negatives, tts.sample_negatives = jorig, torig


def _setup(lr, clip_val, seed=0, u=40, i=90, h=8, b=48, k=4, d=16):
    rng = np.random.default_rng(seed)
    kw = dict(emb_dim=d, num_users=u, num_items=i, max_his=h, num_negs=k,
              batch_size=b, l_r=lr, clip_val=clip_val, seed=seed)
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
    got = tapply(
        torch.from_numpy(table), torch.from_numpy(ids), torch.from_numpy(grads),
        lr=torch.tensor(0.1), clip_val=0.5, writeback=torch.from_numpy(wb),
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert np.abs(got.numpy()).max() < 50
