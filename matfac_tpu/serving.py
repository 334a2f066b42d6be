"""Batch recommendation serving.

The deployment-facing surface the reference lacks entirely (its only
"serving" is offline top-N analysis): load a trained model, keep the
item table device-resident, and answer "top-N unrated items for these
users" with warm-jitted blocked scoring (the eval.ranking engine).

    recommender = Recommender.from_checkpoint(prefix, params, data)
    items, scores = recommender.recommend([12, 99, 1042], n=10)
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

import jax.numpy as jnp

from matfac_tpu.config import Params
from matfac_tpu.eval.ranking import CatalogScorer, topk_catalog_block
from matfac_tpu.models.base import EvalView
from matfac_tpu.utils import freq as ufreq


class Recommender:
    def __init__(self, view: EvalView, train_mat, n_users: int,
                 n_items: int, invalid_users: Optional[np.ndarray] = None,
                 invalid_items: Optional[np.ndarray] = None,
                 user_block: int = 256, item_block: int = 32768):
        if invalid_users is None or invalid_items is None:
            invalid_users, invalid_items = ufreq.invalid_users_items(
                train_mat, n_users, n_items)
        self.view = view
        self.n_users = n_users
        self.user_block = user_block
        self._scorer = CatalogScorer(
            train_mat, invalid_users, invalid_items, n_users, n_items,
            user_block=user_block, item_block=item_block)

    @classmethod
    def from_checkpoint(cls, prefix: str, params: Params, data,
                        model=None, **kw) -> "Recommender":
        """Load text-format factors saved by the training loop."""
        from matfac_tpu.models.base import ModelMF, init_state
        from matfac_tpu.train import checkpoint as ck

        model = model or ModelMF(params, data.n_users, data.n_items)
        sig = ck.model_signature(params, data.n_users, data.n_items)
        state = ck.load_facs(
            init_state(params, data.n_users, data.n_items), prefix, sig)
        if state is None:
            raise FileNotFoundError(
                f"no checkpoint at {prefix}_*Fac_{sig}.mat")
        return cls(model.eval_view(state), data.train_mat, data.n_users,
                   data.n_items, **kw)

    def recommend(self, users: Sequence[int], n: int = 10
                  ) -> Tuple[np.ndarray, np.ndarray]:
        """(item_ids [len(users), n], scores) — excludes each user's
        train-rated and invalid items.

        Scores EXACTLY the queried users in ONE dispatch (query size
        padded to a power-of-two bucket for compile reuse) — scoring
        every user block that covers a query would cost one dispatch
        per distinct block, ~230 blocks for 256 scattered users over a
        100k-user table."""
        users = np.asarray(users, dtype=np.int64)
        if (users < 0).any() or (users >= self.n_users).any():
            raise ValueError("user id out of range")
        sc = self._scorer
        # cache keyed on view identity: replacing self.view (e.g. after
        # more training) must invalidate the padded copy or the
        # recommender would silently serve stale factors
        if getattr(self, "_padded_src", None) is not self.view:
            self._padded_view = sc._pad_view(self.view)
            self._padded_src = self.view
        view = self._padded_view
        # bound the per-dispatch score matrix ([B, item_block] f32) —
        # unbounded query sizes would scale device memory with the
        # request
        cap = 4096
        out_i = np.empty((len(users), n), np.int64)
        out_s = np.empty((len(users), n), np.float32)
        for s in range(0, len(users), cap):
            chunk = users[s:s + cap]
            m = len(chunk)
            B = max(64, 1 << (m - 1).bit_length())
            ids = np.zeros(B, np.int32)
            ids[:m] = chunk
            ids_d = jnp.asarray(ids)
            bv, bi = topk_catalog_block(
                view, ids_d, sc.rated_cols[ids_d], sc.rated_mask[ids_d],
                sc.invalid_items_dev, n, sc.item_block)
            out_i[s:s + m] = np.asarray(bi)[:m]
            out_s[s:s + m] = np.asarray(bv)[:m]
        return out_i, out_s
