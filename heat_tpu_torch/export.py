"""Export trained model parameters for downstream systems.

Counterpart of ``heat_tpu/export.py``: one portable ``.npz`` of plain f32
numpy arrays with the same keys as the JAX package writes (``user_emb``,
``item_emb``, ``w0``, ``attn_q`` where the state has one, and with a
config ``meta_gamma`` and ``meta_similarity``), so either package, or any
numpy consumer, reads the other's files. ``state_from_numpy`` of the
loaded arrays gives a serving state back.
"""

from __future__ import annotations

import numpy as np


def export_embeddings(state, path: str, cfg=None) -> dict:
    """Write the user/item tables and w0 (and attn_q, where present) of
    ``state`` to a compressed ``.npz`` as f32. Returns the dict written.

    Args:
      state: a TrainState (``engine.unpadded_state()``).
      path: output ``.npz`` path.
      cfg: optional CFConfig; records gamma and the similarity so that a
        consumer can reproduce scoring
        (``score = cos(gamma*u + (1-gamma)*pool@w0, i)``).
    """

    def host(x):
        # .float() first: numpy has no bfloat16, and a bf16 table exports
        # exactly as f32.
        return x.detach().cpu().float().numpy()

    out = {
        "user_emb": host(state.user_emb),
        "item_emb": host(state.item_emb),
        "w0": host(state.w0),
    }
    attn_q = getattr(state, "attn_q", None)
    if attn_q is not None:
        out["attn_q"] = host(attn_q)
    if cfg is not None:
        out["meta_gamma"] = np.asarray(cfg.gamma, np.float32)
        out["meta_similarity"] = np.asarray(
            0 if cfg.similarity == "cosine" else 1, np.int32
        )
    np.savez_compressed(path, **out)
    return out


def load_embeddings(path: str) -> dict:
    """Load an :func:`export_embeddings` file back into plain numpy."""
    with np.load(path) as z:
        return {k: z[k] for k in z.files}
