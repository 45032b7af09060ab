"""The port's scores, losses and aggregator against the JAX package.

Inputs are made with numpy from a seed and go through both packages on
the CPU. Elementwise ops agree to rtol 1e-6; reductions over history rows
and the d x d product sum in another order, hence rtol 1e-5 there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from heat_tpu.config import CFConfig as JCFConfig
from heat_tpu.models import aggregator as jagg
from heat_tpu.ops import activations as jact
from heat_tpu.ops import losses as jlosses
from heat_tpu.ops import similarity as jsim
from heat_tpu_torch.config import CFConfig
from heat_tpu_torch.models import aggregator as tagg
from heat_tpu_torch.ops import activations as tact
from heat_tpu_torch.ops import losses as tlosses
from heat_tpu_torch.ops import similarity as tsim


def _rows(seed, b=24, k=4, d=16):
    rng = np.random.default_rng(seed)
    u, p = (rng.normal(size=(b, d)).astype(np.float32) for _ in range(2))
    n = rng.normal(size=(b, k, d)).astype(np.float32)
    u[0] = 0.0  # a zero row exercises the sqrt(1e-8) norm floor
    n[1, 2] = 1e-6
    return u, p, n


def _scores(seed, b=24, k=4):
    rng = np.random.default_rng(seed)
    s_up = rng.uniform(-1, 1, b).astype(np.float32)
    s_un = rng.uniform(-1, 1, (b, k)).astype(np.float32)
    return s_up, s_un


def _t(*xs):
    return [torch.from_numpy(np.asarray(x)) for x in xs]


@pytest.mark.parametrize("similarity", ["cosine", "dot"])
def test_pair_scores_match(similarity):
    u, p, n = _rows(0)
    want = jsim.pair_scores(u, p, n, similarity=similarity)
    got = tsim.pair_scores(*_t(u, p, n), similarity=similarity)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-7)


def test_losses_match():
    s_up, s_un = _scores(1)
    ts_up, ts_un = _t(s_up, s_un)
    pairs = [
        (tlosses.pairwise_logistic_loss(ts_up, ts_un, 14.3),
         jlosses.pairwise_logistic_loss(s_up, s_un, 14.3)),
        (tlosses.cosine_contrastive_loss(ts_up, ts_un, 0.8, 150.0),
         jlosses.cosine_contrastive_loss(s_up, s_un, 0.8, 150.0)),
        (tlosses.sigmoid_pairwise_loss(ts_up, ts_un, 14.3),
         jlosses.sigmoid_pairwise_loss(s_up, s_un, 14.3)),
    ]
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


@pytest.mark.parametrize(
    "loss", ["PairwiseLogisticLoss", "CosineContrastiveLoss", "SigmoidPairwiseLoss"]
)
def test_sample_losses_and_grads_match(loss):
    s_up, s_un = _scores(2)
    jcfg, tcfg = JCFConfig(loss=loss), CFConfig(loss=loss)
    want = jlosses.sample_losses(s_up, s_un, jcfg)
    want_g = jax.grad(
        lambda a, b: jnp.sum(jlosses.sample_losses(a, b, jcfg)), argnums=(0, 1)
    )(s_up, s_un)
    ts_up, ts_un = (x.requires_grad_() for x in _t(s_up, s_un))
    got = tlosses.sample_losses(ts_up, ts_un, tcfg)
    got_g = torch.autograd.grad(got.sum(), (ts_up, ts_un))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-6)
    for g, w in zip(got_g, want_g):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-7)


def test_sigmoid_matches():
    x = np.linspace(-40, 40, 101).astype(np.float32)
    np.testing.assert_allclose(
        tact.sigmoid(torch.from_numpy(x)).numpy(), np.asarray(jact.sigmoid(x)),
        rtol=1e-6,
    )
    np.testing.assert_allclose(
        tact.sigmoid_grad(torch.from_numpy(x)).numpy(),
        np.asarray(jact.sigmoid_grad(x)), rtol=1e-6, atol=1e-12,
    )


def _history(seed, h, n=120, d=16, b=32):
    rng = np.random.default_rng(seed)
    table = rng.normal(size=(n, d)).astype(np.float32)
    his = rng.integers(0, n, (b, h)).astype(np.int32)
    lens = rng.integers(0, h + 1, b).astype(np.int32)
    lens[:2] = [0, h]  # an empty and a full history
    return table, his, lens


def test_history_mean_matches():
    table, his, lens = _history(3, 8)
    embs = table[his]
    want = jagg.history_mean(embs, lens)
    got = tagg.history_mean(*_t(embs, lens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-7)


# H=3 is one chunk of the JAX version (chunk 5 for f32); H=7 is not a
# multiple of the chunk; H=10 is two whole chunks.
@pytest.mark.parametrize("h", [3, 7, 10])
def test_history_mean_fused_matches(h):
    table, his, lens = _history(4 + h, h)
    want = jagg.history_mean_fused(*map(jnp.asarray, (table, his, lens)))
    got = tagg.history_mean_fused(*_t(table, his, lens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-7)
    assert not got[0].any()  # empty history pools to zero


def test_aggregate_history_matches():
    rng = np.random.default_rng(5)
    u, means = (rng.normal(size=(24, 16)).astype(np.float32) for _ in range(2))
    w0 = (rng.normal(size=(16, 16)) * 0.01).astype(np.float32)
    want = jagg.aggregate_history(u, means, w0, 0.4)
    got = tagg.aggregate_history(*_t(u, means, w0), 0.4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-7)
