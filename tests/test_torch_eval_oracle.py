"""The tiled evaluator against the dense host oracle, without JAX.

``evaluate_sim_matrix`` (mask the train items in a dense score matrix, rank
on the host, score) is the reference-compatible path that the JAX package's
tests hold its tiled evaluator to. Here the port's ``TiledEvaluator.topk``
and metric formulas are held to the port's copy of it. The file imports no
JAX, so it runs as it is on a machine that has only PyTorch
(``python -m pytest --noconftest tests/test_torch_eval_oracle.py``), on the
card too.
"""

import numpy as np
import pytest
import torch

from heat_tpu_torch.data.synthetic import synthetic_click_dataset
from heat_tpu_torch.evaluation import evaluator as tev
from heat_tpu_torch.evaluation.evaluator import TiledEvaluator, full_sim_matrix
from heat_tpu_torch.evaluation.metrics import (
    evaluate_metrics,
    evaluate_metrics_device,
    evaluate_sim_matrix,
    pad_truth,
)

METRICS = ["Recall(k=20)", "NormalizedRecall(k=20)", "Precision(k=10)",
           "F1(k=10)", "DCG(k=20)", "NDCG(k=50)", "MRR(k=20)", "HitRate(k=5)",
           "MAP(k=20)"]


@pytest.fixture(params=["cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
def device(request):
    if request.param == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    if request.param == "cuda":
        from heat_tpu_torch.train.engine import set_f32_matmul_precision

        set_f32_matmul_precision()
    return torch.device(request.param)


def _problem(users, items, seed):
    """Planted-cluster clicks and random normal tables: the scores of a
    row are distinct far beyond the rounding of a product."""
    train, test = synthetic_click_dataset(users, items, clicks_per_user=15,
                                          max_his=6, seed=seed)
    rng = np.random.default_rng(seed)
    user = rng.normal(size=(users, 16)).astype(np.float32)
    item = rng.normal(size=(items, 16)).astype(np.float32)
    train_items = [[] for _ in range(users)]
    for u, i in np.asarray(train.pairs):
        train_items[u].append(int(i))
    return train, test, user, item, train_items


@pytest.mark.parametrize("users,items,tile,two_phase", [
    (90, 400, 512, False),   # one tile, torch.topk
    (150, 4500, 64, True),   # three tiles, the two-phase top-k and K4
])
def test_tiled_topk_and_metrics_equal_the_dense_oracle(
        device, users, items, tile, two_phase):
    train, test, user, item, train_items = _problem(users, items, 4)
    assert (items >= tev._TOPK_2PHASE_MIN_ITEMS) == two_phase
    u, i = torch.from_numpy(user).to(device), torch.from_numpy(item).to(device)
    sim = full_sim_matrix(u, i)
    want = evaluate_sim_matrix(METRICS, sim, train_items, test.user_items)

    ev = TiledEvaluator(train.pairs, users, user_tile=tile, num_items=items,
                        device=device)
    scores, ids = ev.topk(u, i, 50, return_scores=True)
    got_host = evaluate_metrics(METRICS, ids.cpu().numpy(), test.user_items)
    truth, truth_len = pad_truth(test.user_items)
    got_dev = evaluate_metrics_device(
        METRICS, ids, torch.as_tensor(truth, device=device),
        torch.as_tensor(truth_len, device=device))
    assert list(got_host) == list(got_dev) == METRICS
    for m in METRICS:
        assert abs(got_host[m] - want[m]) <= 1e-6, (m, got_host[m], want[m])
        assert abs(got_dev[m] - want[m]) <= 1e-6, (m, got_dev[m], want[m])

    # The ranking itself: the oracle's masked scores at the returned ids are
    # the returned scores, descending, and no train item is served.
    masked = sim.copy()
    for row, seen in enumerate(train_items):
        masked[row, seen] = -np.inf
    ids_np, scores_np = ids.cpu().numpy(), scores.cpu().numpy()
    np.testing.assert_allclose(
        np.take_along_axis(masked, ids_np.astype(np.int64), axis=1), scores_np,
        rtol=1e-5, atol=1e-6)
    assert (np.diff(scores_np, axis=1) <= 0).all()
    np.testing.assert_allclose(
        scores_np, -np.sort(-masked, axis=1)[:, :50], rtol=1e-5, atol=1e-6)


def test_sim_matrix_oracle_masks_train_items_and_counts_users_with_truth():
    sim = np.array([[0.9, 0.8, 0.1, 0.7], [0.2, 0.3, 0.4, 0.1]], np.float32)
    got = evaluate_sim_matrix(["Recall(k=1)", "HitRate(k=2)"], sim,
                              [[0], []], [[1], []])
    # User 0: item 0 is masked, item 1 ranks first. User 1 has no truth.
    assert got == {"Recall(k=1)": pytest.approx(1.0), "HitRate(k=2)": 1.0}
    assert sim[0, 0] == np.float32(0.9)  # the caller's matrix is not touched
