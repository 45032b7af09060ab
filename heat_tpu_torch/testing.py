"""What the tests and ``chip_smoke.py`` share, so that the two cannot
drift apart: the comparison rules for two training states computed in
different summation orders (the CPU tests against the JAX package, the
step on the card against the CPU; past a few steps of accum mode, the
distance held to the port's own spread under permuted sums), the
recorder of each step's draws and
loss, and the comparison of replayed epochs with eager ones on clicks
whose steps repeat no id.
"""

from __future__ import annotations

import numpy as np

SHARE = 0.995  # least share of elements within rtol / atol


def is_gradient_array(name: str) -> bool:
    """Arrays that hold gradients (the accum mode's rows, the optimizer
    slots, ``attn_q_m`` and ``attn_q_v`` among them) rather than
    parameters (the tables, ``w0``, ``attn_q``)."""
    return name.endswith(("gacc", "_m", "_v"))


def assert_state_array_close(
    got, want, name: str, *, lr: float, clip_val: float,
    rtol: float = 1e-5, atol: float = 1e-7, cap: float | None = None,
) -> float:
    """Raise AssertionError unless at least SHARE of the elements of ``got``
    are within ``atol + rtol * |want|`` and none is off by more than a cap:
    1e-4 * lr for tables, ``w0`` and ``attn_q``, 1e-3 * clip_val for
    gradient arrays (:func:`is_gradient_array`); ``cap`` replaces the
    former where a caller states another.

    Why a share and a cap: the per-occurrence gradients reach ~1e2 and
    cancel, and Adagrad and Adam divide a combined gradient by its own
    norm, so a few elements in a thousand carry summation-order noise
    above rtol; a wrong update moves a row by ~lr * clip_val (SGD) or ~lr
    (Adam), a wrong accumulation by ~clip_val, far above the cap.

    Returns the largest absolute difference."""
    got, want = np.asarray(got), np.asarray(want)
    diff = np.abs(got - want)
    if diff.size == 0:
        return 0.0
    within = float((diff <= atol + rtol * np.abs(want)).mean())
    if is_gradient_array(name):
        cap = 1e-3 * clip_val
    elif cap is None:
        cap = 1e-4 * lr
    worst = float(diff.max())
    if within < SHARE or not worst <= cap:  # a NaN fails the cap
        raise AssertionError(
            f"{name}: differs by up to {worst:.3g} (cap {cap:.3g}); "
            f"{within:.4f} of the elements within rtol {rtol} / atol {atol} "
            f"(at least {SHARE} required)"
        )
    return worst


SPREAD_MULTIPLE = 4.0  # the spread rule's multiple, stated before measuring


def assert_within_order_spread(
    got, want, runs, name: str, *, multiple: float = SPREAD_MULTIPLE,
) -> dict:
    """The spread rule: raise AssertionError unless ``got`` (a state array
    of the port) lies within ``multiple`` times the port's own summation
    -order spread of ``want`` (the JAX package's), at every element.

    ``runs`` holds the same array from runs of the port that differ from
    ``got``'s only in the order of their sums (:class:`Order`): the
    spread is the largest absolute difference between any two of them and
    ``got``, or one f32 ulp of the largest ``|want|`` where that is larger
    (runs that came out equal).
    The JAX package sums in yet another order, so past the steps where
    cancellation leaves ``assert_state_array_close``'s cap, its distance
    to the port is held to the port's own spread, not to a fixed number.

    Returns the distance, the spread and their ratio."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    arrays = [got] + [np.asarray(r, np.float64) for r in runs]
    spread = max(float(np.abs(a - b).max()) for i, a in enumerate(arrays)
                 for b in arrays[i + 1:])
    floor = float(np.spacing(np.float32(np.abs(want).max())))
    diff = float(np.abs(got - want).max())
    bound = multiple * max(spread, floor)
    if not diff <= bound:  # a NaN fails
        raise AssertionError(
            f"{name}: {diff:.3g} from the JAX package, more than {multiple} x "
            f"the port's order spread {max(spread, floor):.3g}")
    return {"diff": diff, "spread": spread, "floor": floor,
            "ratio": diff / max(spread, floor)}


class Order:
    """The n-th reordering of a step's sums that changes nothing else (0:
    none), for the spread rule's runs of the port: the batch's samples
    permuted with their pinned draws (within each of ``blocks`` equal
    blocks: a mesh's data shards), each sample's K negatives permuted (the
    loss sums over them), and the latent axis permuted in every table and
    in both axes of ``w0`` (every dot product, norm and product sums over
    it; the step is equivariant under it). The samples' order alone would
    leave a sample's own gradient, a sum over its negatives and the latent
    axis, as it was."""

    def __init__(self, n: int, b: int, k: int, d: int, blocks: int = 1):
        rng = np.random.default_rng(1000 + n)
        w = b // blocks
        if n == 0:
            self.samples, self.negs, self.dims = (
                np.arange(b), np.arange(k), np.arange(d))
        else:
            self.samples = np.concatenate(
                [i * w + rng.permutation(w) for i in range(blocks)])
            self.negs, self.dims = rng.permutation(k), rng.permutation(d)
        self.back = np.argsort(self.dims)

    def state(self, arrays: dict) -> dict:
        """``arrays`` (numpy, the latent axis last; None entries kept) in
        this order's latent axis."""
        return {k: None if v is None else np.ascontiguousarray(
            v[np.ix_(self.dims, self.dims)] if k == "w0" else v[:, self.dims])
            for k, v in arrays.items()}

    def restore(self, state: dict) -> dict:
        """A numpy state of the port back in the given latent order."""
        out = dict(state)
        for k, v in state.items():
            if isinstance(v, np.ndarray) and v.ndim == 2:
                out[k] = (v[np.ix_(self.back, self.back)] if k == "w0"
                          else v[:, self.back])
        return out


def hold_by_order_spread(runs, want, first: int = 3) -> dict:
    """Steps ``first`` on of the port's runs against the JAX package's by
    :func:`assert_within_order_spread`, array by array and the loss:
    ``runs`` a list of (losses, states), ``runs[0]`` in the given order
    and the others reordered (:class:`Order`), each state a numpy state a
    step (``state_to_numpy``'s keys; ``lr`` and ``step`` are not held
    here); ``want`` the JAX package's (losses, states). Returns the
    largest ratio of each array."""
    ratios = {}
    for step in range(first - 1, len(want[1])):
        got, others = runs[0][1][step], [r[1][step] for r in runs[1:]]
        for name, value in want[1][step].items():
            if name in ("lr", "step") or value is None:
                continue
            out = assert_within_order_spread(
                got[name], value, [o[name] for o in others],
                f"{name}, step {step + 1}")
            ratios[name] = max(ratios.get(name, 0.0), out["ratio"])
        out = assert_within_order_spread(
            runs[0][0][step], want[0][step], [r[0][step] for r in runs[1:]],
            f"loss, step {step + 1}")
        ratios["loss"] = max(ratios.get("loss", 0.0), out["ratio"])
    return ratios


class StepRecorder:
    """Wraps ``train_step.sample_negatives`` and ``train_step.train_step``
    and writes each step's draws and loss into device buffers at a device
    counter, which a captured step replays too. ``full``: every negative,
    tile index and tile as drawn, and the step's positives (``pos``) and the
    negative ids it reads (``negs``: the draws remapped through a
    sub-epoch's negative pool where it has one); otherwise a fingerprint a
    step of the draws (an int64 weighted sum). ``steps`` bounds the steps
    recorded. Installed for the duration of a ``with`` block, which must
    hold the capture: the graph records whatever the step calls."""

    def __init__(self, steps, batch, negs, tile, device, full):
        import torch

        import heat_tpu_torch.train.train_step as ts

        self.ts, self.full = ts, full
        self.orig = (ts.sample_negatives, ts.train_step)
        self.count = torch.zeros(1, dtype=torch.int64, device=device)
        self.losses = torch.zeros(steps, dtype=torch.float32, device=device)
        if full:
            self.ids = torch.zeros((steps, batch, negs), dtype=torch.int32,
                                   device=device)
            self.idx = torch.zeros_like(self.ids)
            self.tiles = torch.zeros((steps, max(tile, 1)), dtype=torch.int32,
                                     device=device)
            self.pos = torch.zeros((steps, batch), dtype=torch.int32,
                                   device=device)
            self.negs = torch.zeros_like(self.ids)
        else:
            self.prints = torch.zeros((steps, 3), dtype=torch.int64,
                                      device=device)
            self.weights = torch.arange(batch * negs, device=device) % 1021 + 1

    def sample(self, generator, state, pos_ids, cfg, real=None):
        import torch

        sample, state = self.orig[0](generator, state, pos_ids, cfg, real=real)
        tiled = sample.tile is not None
        if self.full:
            self.ids.index_copy_(0, self.count, sample.ids[None])
            if tiled:
                self.idx.index_copy_(0, self.count, sample.tile_idx[None])
                self.tiles.index_copy_(0, self.count, sample.tile[None])
        else:
            w = self.weights
            zero = torch.zeros((), dtype=torch.int64, device=w.device)
            self.prints.index_copy_(0, self.count, torch.stack([
                (sample.ids.reshape(-1).long() * w).sum(),
                (sample.tile_idx.reshape(-1).long() * w).sum() if tiled else zero,
                (sample.tile.long() * w[: sample.tile.shape[0]]).sum()
                if tiled else zero,
            ])[None])
        self.count += 1
        return sample, state

    def step(self, *args, **kw):
        import torch

        state, sampler_state, loss = self.orig[1](*args, **kw)
        at = self.count - 1
        self.losses.index_copy_(0, at, loss.view(1))
        if self.full:
            self.pos.index_copy_(0, at, args[3].pos[None])
            negs = self.ids.index_select(0, at)[0]
            pool = kw.get("neg_candidates")
            if pool is not None:
                size = kw.get("neg_candidates_size")
                negs = pool.index_select(0, torch.remainder(
                    negs, pool.shape[0] if size is None else size
                ).view(-1)).view(negs.shape)
            self.negs.index_copy_(0, at, negs[None])
        return state, sampler_state, loss

    def __enter__(self):
        self.ts.sample_negatives, self.ts.train_step = self.sample, self.step
        return self

    def __exit__(self, *exc):
        self.ts.sample_negatives, self.ts.train_step = self.orig

    def records(self) -> list:
        """Clones of the draws, then of the step losses."""
        draws = [self.ids, self.idx, self.tiles] if self.full else [self.prints]
        return [t.clone() for t in (*draws, self.losses)]


def distinct_id_dataset(clicks: int, num_items: int, max_his: int, seed: int = 0):
    """A ClickDataset of ``clicks`` clicks by ``clicks`` users, each user and
    each clicked item once, so that however an epoch is shuffled no batch
    repeats a user or a positive. Histories: uniform random items (they
    receive no gradient), lengths 1 to ``max_his``."""
    from heat_tpu_torch.data.datasets import ClickDataset

    rng = np.random.default_rng(seed)
    users = rng.permutation(clicks).astype(np.int32)
    items = rng.choice(num_items, clicks, replace=False).astype(np.int32)
    return ClickDataset(
        pairs=np.stack([users, items], axis=1),
        his_items=rng.integers(0, num_items, (clicks, max_his)).astype(np.int32),
        masks=rng.integers(1, max_his + 1, clicks).astype(np.int32),
        num_users=clicks, num_items=num_items, max_his=max_his, user_items=[],
    )


def replayed_equals_eager(make_engine, epochs: int) -> dict:
    """Holds replayed epochs bit for bit to eager ones where the step is
    deterministic: no row of a table receives two adds in a step, so K3's
    atomics add in a fixed order.

    ``make_engine()`` gives a fresh CUDA engine on a ``distinct_id_dataset``
    (no batch repeats a user or a positive), with sub-epochs or without
    (then each epoch takes one step more for each sub-epoch past the first
    at most). Three engines from it run
    ``epochs`` ``train_one_epoch`` calls each: eager, eager again and
    replayed (each step one replay of the captured step, the first step
    the capture's eager warm-up), every step's draws and loss recorded
    (``StepRecorder``). After every epoch (its shuffle and, under
    ``his_refresh: subepoch``, its pool refresh come before its first
    step), both tables, ``w0``, ``attn_q`` (self-attention), ``step``,
    ``lr``, the sampler's ``iterations`` and tile and the epoch loss are
    taken. Raises unless
    every step's item ids (positives, and the negatives or the tile) are
    distinct; unless the two eager runs agree bit for bit (otherwise
    something else in the step is not deterministic, and equality proves
    nothing); and unless the replayed run equals them in every step's
    draws and loss and in everything taken after every epoch. Returns the
    steps compared and the replayed engine's captures."""
    import torch

    runs = {}
    for name, capture in (("eager", False), ("eager_again", False),
                          ("replayed", True)):
        engine = make_engine()
        engine._capture = capture
        cfg = engine.cfg
        tiled = cfg.neg_sampler == 1
        nb = -(-cfg.train_size // cfg.batch_size) + cfg.num_subepochs - 1
        rec = StepRecorder(epochs * nb, cfg.batch_size, cfg.num_negs,
                           cfg.tile_size if tiled else 0, engine.device, True)
        taken = []
        with rec:
            for _ in range(epochs):
                loss = engine.train_one_epoch()
                st, ss = engine.state, engine.sampler_state
                taken.append([loss] + [t.clone() for t in (
                    st.user_emb, st.item_emb, st.w0, st.step, st.lr,
                    ss.iterations) + ((ss.tile,) if tiled else ())
                    + (() if st.attn_q is None else (st.attn_q,))])
        runs[name] = (rec.records(), taken, int(rec.count), engine)
    (draws, taken, steps, engine) = runs["eager"]
    if steps != int(engine.state.step) or (
            engine.cfg.num_subepochs == 1 and steps != epochs * nb):
        raise AssertionError(f"{steps} steps recorded, {int(engine.state.step)} taken")
    positives = engine.pairs[:, 1]
    ids, idx, tiles, _ = draws
    for s in range(steps):
        negs = tiles[s] if tiled else ids[s].reshape(-1)
        step_ids = torch.cat([negs, positives])
        if torch.unique(step_ids).numel() != step_ids.numel():
            raise AssertionError(
                f"step {s} drew an item id twice or a positive: the "
                f"comparison needs distinct ids (another seed or more items)")

    def same(a, b):
        return all(
            (x == y) if isinstance(x, float) else torch.equal(x, y)
            for x, y in zip(a, b))

    for other in ("eager_again", "replayed"):
        o_draws, o_taken, o_count, _ = runs[other]
        what = ("the second eager run" if other == "eager_again"
                else "the replayed run")
        if o_count != steps or not same(draws, o_draws):
            raise AssertionError(f"{what} drew or lost other values than the eager run")
        for e, (a, b) in enumerate(zip(taken, o_taken)):
            if not same(a, b):
                names = ["loss", "user_emb", "item_emb", "w0", "step", "lr",
                         "iterations"] + ["tile"] * tiled + ["attn_q"]
                off = [n for n, x, y in zip(names, a, b) if not (
                    (x == y) if isinstance(x, float) else torch.equal(x, y))]
                raise AssertionError(
                    f"after epoch {e + 1}, {what} differs from the eager run "
                    f"in {off}")
    return {"epochs": epochs, "steps": steps,
            "captures": runs["replayed"][3]._epoch_fns[True].captures}
