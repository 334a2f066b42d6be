"""Ranking evaluation: full-catalog top-N scoring, leave-one-out HR@N,
ARHR.

JAX analog of Model::hitRate (model.cpp:1158-1211) and
Model::arHR (model.cpp:981-1034). The reference walks all items per user
through a heap; here scoring is blocked dense matmul (users x items on
matmuls) with rated-item / invalid-item exclusion applied as -inf masks
and a running top-k merge across item blocks — the "sharded scoring
kernel" of SURVEY.md §7.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import PartitionSpec as P

from matfac_tpu.data.csr import RatingMatrix
from matfac_tpu.models.base import EvalView

NEG_INF = jnp.float32(-3e38)


def _exact_topk_tiles(scores: jax.Array, n: int, tile: int = 128
                      ) -> Tuple[jax.Array, jax.Array]:
    """EXACT top-n via two-stage tile selection.

    Stage 1: max over contiguous 128-wide tiles, stable top_k over the
    tile maxima. Any tile containing a top-n element has max >= the
    n-th score and at most n-1 tiles rank strictly above it, so the
    top-n tiles contain every top-n element. Stage 2: gather those n
    tiles (sorted by tile id so candidate order = global index order,
    preserving XLA top_k's lowest-index-on-tie behavior) and run the
    small top_k over [B, n*tile].

    The tile max is one reduction pass, after which top_k runs over
    N/tile maxima and n*tile candidates instead of all N scores. It
    was written for an accelerator where lax.top_k over [B, N] was
    slow; whether it beats plain lax.top_k on a GPU is measured by
    scripts/gpu_xla_baselines.py (PERF.md). Falls back to lax.top_k
    when the tile decomposition cannot win (n*tile >= N) or does not
    divide.
    """
    B, N = scores.shape
    nt = N // tile
    if N % tile or nt < n or n * tile >= N:
        return jax.lax.top_k(scores, n)
    t = scores.reshape(B, nt, tile)
    tmax = jnp.max(t, axis=2)
    _, tsel = jax.lax.top_k(tmax, n)              # [B, n] tile ids
    tsel = jnp.sort(tsel, axis=1)                 # global index order
    cand = jnp.take_along_axis(t, tsel[:, :, None], axis=1)
    cand = cand.reshape(B, n * tile)
    s, ci = jax.lax.top_k(cand, n)
    idx = (jnp.take_along_axis(tsel, ci // tile, axis=1) * tile
           + ci % tile)
    return s, idx.astype(jnp.int32)


def _topk_user_block(view: EvalView, user_ids: jax.Array, exclude,
                     invalid_items: jax.Array, n: int, item_block: int
                     ) -> Tuple[jax.Array, jax.Array]:
    """Shared score → exclude → tile-top-k → merge scan over item
    blocks; ``exclude(scores, s0) -> scores`` applies the rated-item
    exclusion (the only step that differs between the padded-row and
    COO staging). Returns (scores[B, n], item_ids[B, n]) descending."""
    B = user_ids.shape[0]
    n_items = view.i_fac.shape[0]
    n_blocks = n_items // item_block
    u = view.u_fac[user_ids]                    # [B, k]
    u_bias = view.u_bias[user_ids]

    def body(carry, blk):
        best_s, best_i = carry
        s0 = blk * item_block
        i_fac_blk = jax.lax.dynamic_slice_in_dim(view.i_fac, s0, item_block)
        i_bias_blk = jax.lax.dynamic_slice_in_dim(view.i_bias, s0, item_block)
        inval_blk = jax.lax.dynamic_slice_in_dim(invalid_items, s0,
                                                 item_block)
        # full f32 scores: at the default precision a GPU may round
        # the operands to TF32 (10 mantissa bits), which reorders
        # near-tied items against an exact ranking (chip_smoke.py
        # top-10 check, PERF.md)
        scores = (jnp.dot(u, i_fac_blk.T,
                          preferred_element_type=jnp.float32,
                          precision=jax.lax.Precision.HIGHEST)
                  + view.mu + u_bias[:, None] + i_bias_blk[None, :])
        scores = jnp.where(inval_blk[None, :], NEG_INF, scores)
        scores = exclude(scores, s0)
        # block-local exact top-n (tile-accelerated), then a tiny merge
        # with the running winners; carry sits first in the concat so
        # earlier blocks keep lowest-index tie preference
        blk_s, blk_i = _exact_topk_tiles(scores, min(n, item_block))
        cat_s = jnp.concatenate([best_s, blk_s], axis=1)
        cat_i = jnp.concatenate([best_i, s0 + blk_i], axis=1)
        new_s, sel = jax.lax.top_k(cat_s, n)
        new_i = jnp.take_along_axis(cat_i, sel, axis=1)
        return (new_s, new_i), None

    # padding slot ids are -1, NOT 0: when a user has fewer than n
    # scorable items the init slots survive the merge, and a raw id 0
    # would falsely match item 0 in the LOO credit/rank matchers
    # (review r3)
    init = (jnp.full((B, n), NEG_INF),
            jnp.full((B, n), -1, jnp.int32))
    (best_s, best_i), _ = jax.lax.scan(body, init,
                                       jnp.arange(n_blocks, dtype=jnp.int32))
    return best_s, best_i


@functools.partial(jax.jit, static_argnames=("n", "item_block"))
def topk_catalog_block(view: EvalView, user_ids: jax.Array,
                       rated_cols: jax.Array, rated_mask: jax.Array,
                       invalid_items: jax.Array, n: int,
                       item_block: int) -> Tuple[jax.Array, jax.Array]:
    """Top-n unrated items for a block of users.

    view.i_fac must be padded to a multiple of item_block with padded
    rows marked invalid. rated_cols/rated_mask: [B, C] padded rated
    lists per user (exclusion set, = train row). Returns (scores[B, n],
    item_ids[B, n]) sorted descending.
    """
    B = user_ids.shape[0]
    row_ids = jnp.arange(B, dtype=jnp.int32)[:, None]

    def exclude(scores, s0):
        # exclude each user's rated items that fall in this block
        off = rated_cols - s0
        in_blk = (off >= 0) & (off < item_block) & (rated_mask > 0)
        off = jnp.where(in_blk, off, 0)
        return scores.at[row_ids, off].min(
            jnp.where(in_blk, NEG_INF, jnp.float32(3e38)), mode="drop")

    return _topk_user_block(view, user_ids, exclude, invalid_items, n,
                            item_block)


@functools.partial(jax.jit, static_argnames=("n", "item_block"))
def _topk_all_blocks(view: EvalView, user_id_blocks: jax.Array,
                     rated_cols: jax.Array, rated_mask: jax.Array,
                     invalid_items: jax.Array, n: int, item_block: int):
    def one_block(_, ids):
        bs, bi = topk_catalog_block(view, ids, rated_cols[ids],
                                    rated_mask[ids], invalid_items, n,
                                    item_block)
        return _, (bs, bi)

    _, (all_s, all_i) = jax.lax.scan(one_block, None, user_id_blocks)
    return all_s, all_i


@functools.partial(jax.jit, static_argnames=("n", "item_block"))
def _topk_block_coo(view: EvalView, user_ids: jax.Array,
                    ex_rows: jax.Array, ex_cols: jax.Array,
                    invalid_items: jax.Array, n: int, item_block: int
                    ) -> Tuple[jax.Array, jax.Array]:
    """topk_catalog_block with FLAT COO exclusion: (local row, col)
    pairs of the block's rated entries, padded with out-of-range cols.
    Scatter cost is the block's nnz instead of B x max-degree — on
    power-law data the padded-row scatter was the eval wall (a few
    heavy users set C for everyone; PERF.md)."""

    def exclude(scores, s0):
        # out-of-block / padding cols land out of range -> dropped.
        # NB: .at[] wraps NEGATIVE indices numpy-style even under
        # mode="drop", so map them to an out-of-bounds POSITIVE index.
        off = ex_cols - s0
        off = jnp.where(off >= 0, off, item_block)
        return scores.at[ex_rows, off].min(NEG_INF, mode="drop")

    return _topk_user_block(view, user_ids, exclude, invalid_items, n,
                            item_block)


@functools.partial(jax.jit, static_argnames=("n", "item_block"))
def _topk_all_blocks_coo(view: EvalView, user_id_blocks: jax.Array,
                         ex_rows: jax.Array, ex_cols: jax.Array,
                         invalid_items: jax.Array, n: int,
                         item_block: int):
    def one_block(_, xs):
        ids, exr, exc = xs
        bs, bi = _topk_block_coo(view, ids, exr, exc, invalid_items, n,
                                 item_block)
        return _, (bs, bi)

    _, (all_s, all_i) = jax.lax.scan(one_block, None,
                                     (user_id_blocks, ex_rows, ex_cols))
    return all_s, all_i


class CatalogScorer:
    """Host wrapper: pads the item table, stages exclusion lists, and
    streams user blocks through topk_catalog_block.

    ``mesh``: a jax.sharding.Mesh shards the catalog pass over ALL its
    devices — user blocks are split across the mesh (each device scans
    the full item catalog for its user shard under shard_map) and the
    LOO credit reduces with a psum, so multi-chip training stops paying
    single-device eval (SURVEY §7 "Eval cost"; the reference's hot loop
    is the per-user full-catalog heap scan, model.cpp:1182-1193).
    User-sharding is the communication-free axis: the only collective
    is the scalar credit psum (+ a one-time item-table all-gather when
    the incoming view is item-sharded); an item-sharded scan would
    ppermute [B, n] candidate sets every block for no FLOP savings.
    Results are EXACTLY the single-device results (same per-user block
    computation, integer-valued credit sums)."""

    def __init__(self, train_mat: RatingMatrix, invalid_users: np.ndarray,
                 invalid_items: np.ndarray, n_users: int, n_items: int,
                 user_block: int = 1024, item_block: int = 32768,
                 mesh=None):
        self.n_users = n_users
        self.n_items = n_items
        self.user_block = user_block
        self.mesh = mesh
        self.n_shards = int(mesh.devices.size) if mesh is not None else 1
        self._shard_fns = {}
        self.item_block = min(item_block, _round_up(n_items, 128))
        self.n_items_pad = _round_up(n_items, self.item_block)
        inval = np.ones(self.n_items_pad, bool)
        inval[:n_items] = invalid_items[:n_items]
        self.invalid_items_dev = jnp.asarray(inval)
        self.invalid_users = invalid_users
        self._train_mat = train_mat
        # flat COO exclusion per FIXED user block: total scatter indices
        # = nnz (+ block padding) instead of B x max-degree — the
        # padded-row scatter cost is set by the single heaviest user on
        # power-law data. Rows with col sentinel 2**30 drop out of every
        # item block.
        B = user_block
        # user blocks round up to a shard multiple so shard_map splits
        # them evenly (pad blocks score dummy user 0; valid=False)
        n_blocks = _round_up(_round_up(n_users, B) // B, self.n_shards)
        self._n_blocks = n_blocks
        r, c, _ = train_mat.to_coo()
        keep = (r < n_users) & (c < n_items)
        r, c = r[keep], c[keep]
        blk = r // B
        counts = np.bincount(blk, minlength=n_blocks)
        E = max(int(counts.max()) if len(counts) else 0, 1)
        # skew guard: when heavy users cluster in one id block (e.g.
        # frequency-sorted datasets), per-block padding re-creates the
        # blowup this layout exists to remove — fall back to the
        # padded-row path there (its cost is B x max-degree instead)
        avg = max(len(r) // n_blocks, 1)
        self._use_coo = E <= max(4 * avg + 64, 1024)
        if self._use_coo:
            ex_rows = np.zeros((n_blocks, E), np.int32)
            ex_cols = np.full((n_blocks, E), 2 ** 30, np.int32)
            order = np.argsort(blk, kind="stable")
            offs = np.zeros(n_blocks + 1, np.int64)
            np.cumsum(counts, out=offs[1:])
            rs, cs = r[order], c[order]
            for b in range(n_blocks):
                lo, hi = offs[b], offs[b + 1]
                ex_rows[b, : hi - lo] = (rs[lo:hi] - b * B
                                         ).astype(np.int32)
                ex_cols[b, : hi - lo] = cs[lo:hi].astype(np.int32)
            self.ex_rows = self._place(jnp.asarray(ex_rows))
            self.ex_cols = self._place(jnp.asarray(ex_cols))
        self._rated_rows = None   # lazy [n_users, C] staging (serving)
        self._blocks_dev = None   # lazy [n_blocks, B] user-id blocks

    def _place(self, arr: jax.Array) -> jax.Array:
        """Pre-distribute a [n_blocks, ...] staged array over the mesh
        (no-op without one) so every eval dispatch starts shard-local."""
        if self.mesh is None:
            return arr
        from jax.sharding import NamedSharding
        sh = NamedSharding(self.mesh, P(tuple(self.mesh.axis_names)))
        return jax.device_put(arr, sh)

    def _ensure_padded_rows(self):
        """[n_users, max_degree] padded rated rows — only needed by the
        arbitrary-user-block path (serving); O(n_users * max_degree)
        memory, so built lazily."""
        if self._rated_rows is None:
            cols, _, mask = self._train_mat.pad_rows()
            if self._train_mat.nrows < self.n_users:
                pad = self.n_users - self._train_mat.nrows
                cols = np.pad(cols, ((0, pad), (0, 0)))
                mask = np.pad(mask, ((0, pad), (0, 0)))
            self._rated_rows = (jnp.asarray(cols),
                                jnp.asarray(mask.astype(np.float32)))
        return self._rated_rows

    @property
    def rated_cols(self) -> jax.Array:
        return self._ensure_padded_rows()[0]

    @property
    def rated_mask(self) -> jax.Array:
        return self._ensure_padded_rows()[1]

    def _pad_view(self, view: EvalView) -> EvalView:
        n_pad = self.n_items_pad - view.i_fac.shape[0]
        if n_pad == 0:
            return view
        return view._replace(
            i_fac=jnp.pad(view.i_fac, ((0, n_pad), (0, 0))),
            i_bias=jnp.pad(view.i_bias, (0, n_pad)))

    def _sharded(self, n: int):
        """jit(shard_map(...)) over the mesh: the leading user-block
        axis splits across every mesh axis; view/exclusion tables are
        replicated (a sharded incoming view is re-laid-out by the
        dispatch — one all-gather of the small factor tables)."""
        key = (n, self._use_coo)
        fn = self._shard_fns.get(key)
        if fn is not None:
            return fn
        axes = tuple(self.mesh.axis_names)
        inner = _topk_all_blocks_coo if self._use_coo else _topk_all_blocks

        def run(view, blocks, e1, e2, invalid):
            return inner(view, blocks, e1, e2, invalid, n,
                         self.item_block)

        fn = jax.jit(jax.shard_map(
            run, mesh=self.mesh,
            in_specs=(P(), P(axes), P(axes) if self._use_coo else P(),
                      P(axes) if self._use_coo else P(), P()),
            out_specs=(P(axes), P(axes)),
            # the scan carry mixes replicated init constants with
            # varying scanned inputs; there is no cross-device op in
            # the topk body, so skip the varying-axes type check
            check_vma=False))
        self._shard_fns[key] = fn
        return fn

    def _topk_dev(self, view: EvalView, n: int
                  ) -> Tuple[jax.Array, jax.Array]:
        """Device-resident [blocks, B, n] (scores, item ids)."""
        view = self._pad_view(view)
        B = self.user_block
        if self._blocks_dev is None:
            user_ids_all = np.arange(self._n_blocks * B, dtype=np.int32)
            user_ids_all[self.n_users:] = 0
            self._blocks_dev = self._place(
                jnp.asarray(user_ids_all.reshape(-1, B)))
        blocks = self._blocks_dev
        if self._use_coo:
            e1, e2 = self.ex_rows, self.ex_cols
        else:
            e1, e2 = self._ensure_padded_rows()
        if self.mesh is not None:
            return self._sharded(n)(view, blocks, e1, e2,
                                    self.invalid_items_dev)
        if self._use_coo:
            return _topk_all_blocks_coo(view, blocks, e1, e2,
                                        self.invalid_items_dev, n,
                                        self.item_block)
        return _topk_all_blocks(view, blocks, e1, e2,
                                self.invalid_items_dev, n,
                                self.item_block)

    def topk(self, view: EvalView, n: int
             ) -> Tuple[np.ndarray, np.ndarray]:
        """[n_users, n] (scores, item ids) of top unrated items.

        All user blocks run inside ONE jitted scan — a single device
        dispatch per catalog pass, with no host round trip per
        block."""
        all_s, all_i = self._topk_dev(view, n)
        n_users_pad = all_s.shape[0] * all_s.shape[1]
        return (np.asarray(all_s).reshape(n_users_pad, n)[: self.n_users],
                np.asarray(all_i).reshape(n_users_pad, n)[: self.n_users])

    # ------------------------------------------------------------------
    def _loo_staged(self, test_mat: RatingMatrix):
        """Stage (first test item, valid mask) for device-side LOO
        scoring; cached per test matrix (the training loop evaluates
        the same val matrix every epoch). The cache holds the matrix
        itself and compares by identity — an id() key without a
        reference can alias a new matrix at a recycled address."""
        if getattr(self, "_loo_mat", None) is test_mat:
            return self._loo_cache
        deg = test_mat.row_degrees()
        nr = min(test_mat.nrows, self.n_users)
        first = np.zeros(self.n_users, np.int32)
        valid = np.zeros(self.n_users, bool)
        nz = deg[:nr] > 0
        first[:nr][nz] = test_mat.indices[test_mat.indptr[:nr][nz]]
        valid[:nr] = nz & ~self.invalid_users[:nr]
        B = self.user_block
        n_users_pad = self._n_blocks * B
        first = np.pad(first, (0, n_users_pad - self.n_users))
        valid = np.pad(valid, (0, n_users_pad - self.n_users))
        # co-sharded with the topk output so the credit reduction stays
        # shard-local (only the scalar psums)
        self._loo_cache = (self._place(jnp.asarray(first.reshape(-1, B))),
                           self._place(jnp.asarray(valid.reshape(-1, B))),
                           int(valid.sum()))
        self._loo_mat = test_mat
        return self._loo_cache

    def hit_rate(self, view: EvalView, test_mat: RatingMatrix,
                 n: int = 10) -> float:
        """Leave-one-out HR@n (model.cpp:1158-1211): the held-out item is
        the FIRST entry of each user's test row; denominator = all valid
        users (with a nonempty test row). Scored on-device — only the
        scalar leaves the device, not the [n_users, n] id table."""
        first, valid, n_val = self._loo_staged(test_mat)
        if n_val == 0:
            return 0.0
        _, top_i = self._topk_dev(view, n)
        return float(_loo_credit_dev(top_i, first, valid, False)) / n_val

    def arhr(self, view: EvalView, test_mat: RatingMatrix,
             n: int = 1000) -> float:
        """ARHR over top-n (model.cpp:981-1034): 1/(rank+1) credit."""
        first, valid, n_val = self._loo_staged(test_mat)
        if n_val == 0:
            return 0.0
        _, top_i = self._topk_dev(view, n)
        return float(_loo_credit_dev(top_i, first, valid, True)) / n_val


@functools.partial(jax.jit, static_argnames=("reciprocal",))
def _loo_credit_dev(top_i: jax.Array, first: jax.Array,
                    valid: jax.Array, reciprocal: bool) -> jax.Array:
    """Sum of LOO credits on-device. top_i [blocks, B, n];
    first/valid [blocks, B]."""
    match = top_i == first[:, :, None]
    has_hit = match.any(axis=2) & valid
    if reciprocal:
        rank = jnp.argmax(match, axis=2)
        credit = jnp.where(has_hit, 1.0 / (rank + 1.0), 0.0)
    else:
        # f32 sum of 0/1 credits is exact below 2^24 valid users
        credit = has_hit.astype(jnp.float32)
    return jnp.sum(credit)


def _loo_score(top_i: np.ndarray, test_mat: RatingMatrix,
               invalid_users: np.ndarray, n_users: int,
               reciprocal: bool) -> float:
    deg = test_mat.row_degrees()
    nr = min(test_mat.nrows, n_users)
    first = np.zeros(nr, dtype=np.int64)
    nz = deg[:nr] > 0
    first[nz] = test_mat.indices[test_mat.indptr[:nr][nz]]
    valid = nz & ~invalid_users[:nr]
    n_val = int(valid.sum())
    if n_val == 0:
        return 0.0
    match = top_i[:nr] == first[:, None]          # [nr, N]
    has_hit = match.any(axis=1) & valid
    if reciprocal:
        rank = np.argmax(match, axis=1)           # first hit position
        credit = np.where(has_hit, 1.0 / (rank + 1.0), 0.0)
    else:
        credit = has_hit.astype(np.float64)
    return float(credit.sum()) / n_val


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


# ----------------------------------------------------------------------
# Sampled-negatives ranking protocol (non-saturated parity rows)
# ----------------------------------------------------------------------

def sample_negatives(test_mat: RatingMatrix, train_mat: RatingMatrix,
                     invalid_users: np.ndarray,
                     invalid_items: np.ndarray, n_users: int,
                     n_items: int, n_candidates: int = 1000,
                     popularity: "np.ndarray | None" = None,
                     seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Per-user candidate sets for the sampled LOO protocol: column 0 =
    the held-out (first test) item, columns 1.. = negatives drawn from
    ``popularity`` (None = uniform) with the user's train-rated items,
    the held-out item, and invalid items rejected by vectorized
    resampling. The full-catalog LOO HR@10 saturates (~1.0) on strong
    models at ML scales; popularity-weighted negatives are the standard
    hard-negative protocol (the reference's own longTail analyses
    sample 1000 unrated negatives per test item, longTail.cpp:279-502).
    Returns (cands [n_val, n_candidates] int32, user_ids [n_val])."""
    rng = np.random.default_rng(seed)
    deg = test_mat.row_degrees()
    nr = min(test_mat.nrows, n_users)
    nz = deg[:nr] > 0
    users = np.nonzero(nz & ~invalid_users[:nr])[0]
    first = test_mat.indices[test_mat.indptr[:nr][users]].astype(np.int64)

    p = None
    if popularity is not None:
        w = np.asarray(popularity, np.float64).copy()
        w[invalid_items[: len(w)]] = 0.0
        w = np.maximum(w, 0.0)
        mass = w.sum()
        # a popularity vector whose mass sits entirely on invalid items
        # would yield p = w/0 = NaN and an opaque rng.choice failure —
        # fall back to uniform candidates instead
        p = w / mass if mass > 0 else None
    M = n_candidates - 1
    cands = np.empty((len(users), M), np.int64)
    todo = np.ones((len(users), M), bool)
    # global sorted (user, item) key array: rated-membership for any
    # (u, d) pair is one vectorized binary search (CSR rows are sorted
    # by construction, so keys are globally sorted)
    r_all, c_all, _ = train_mat.to_coo()
    keys = r_all.astype(np.int64) * n_items + c_all.astype(np.int64)
    inval_i = np.zeros(n_items, bool)
    inval_i[: len(invalid_items)] = invalid_items[:n_items]
    row_user = np.broadcast_to(users[:, None], todo.shape)
    row_first = np.broadcast_to(first[:, None], todo.shape)
    for _ in range(50):
        n_todo = int(todo.sum())
        if n_todo == 0:
            break
        draw = rng.choice(n_items, size=n_todo, p=p)
        kq = row_user[todo].astype(np.int64) * n_items + draw
        pos = np.searchsorted(keys, kq)
        rated = np.zeros(n_todo, bool)
        inb = pos < len(keys)
        rated[inb] = keys[pos[inb]] == kq[inb]
        bad = rated | (draw == row_first[todo]) | inval_i[draw]
        cands[todo] = draw
        new_todo = np.zeros_like(todo)
        new_todo[todo] = bad
        todo = new_todo
    if todo.any():
        # popularity mass may be concentrated in a user's rated set;
        # fall back to uniform for the stragglers (same rejection)
        rows, colsx = np.nonzero(todo)
        for i, (a, b) in enumerate(zip(rows, colsx)):
            while True:
                d = int(rng.integers(0, n_items))
                kq = int(users[a]) * n_items + d
                j = np.searchsorted(keys, kq)
                if (d != first[a] and not inval_i[d]
                        and not (j < len(keys) and keys[j] == kq)):
                    cands[a, b] = d
                    break
    out = np.concatenate([first[:, None], cands], axis=1)
    return out.astype(np.int32), users.astype(np.int32)


@functools.partial(jax.jit, static_argnames=("n", "blk"))
def _sampled_rank_dev(u_fac, i_fac, u_bias, i_bias, mu, users, cands,
                      n: int, blk: int):
    """rank of column 0 among each row's candidates (strict greater —
    ties favor the held-out) summed into HR@n and 1/(rank+1) credits."""
    def body(carry, s):
        hr, ar = carry
        u = jax.lax.dynamic_slice_in_dim(users, s * blk, blk)
        cd = jax.lax.dynamic_slice_in_dim(cands, s * blk, blk)
        pu = u_fac[u]                                  # [blk, k]
        qi = i_fac[cd]                                 # [blk, M, k]
        sc = jnp.einsum("bk,bmk->bm", pu, qi,
                        preferred_element_type=jnp.float32)
        sc = sc + i_bias[cd] + u_bias[u][:, None] + mu
        rank = jnp.sum(sc[:, 1:] > sc[:, :1], axis=1)  # [blk]
        w = (u >= 0).astype(jnp.float32)               # pad rows: u=-1
        hr = hr + jnp.sum(w * (rank < n))
        ar = ar + jnp.sum(w * (rank < n) / (rank + 1.0))
        return (hr, ar), None

    nb = users.shape[0] // blk
    (hr, ar), _ = jax.lax.scan(body, (jnp.float32(0), jnp.float32(0)),
                               jnp.arange(nb, dtype=jnp.int32))
    return hr, ar


def sampled_ranking_metrics(view: EvalView, test_mat: RatingMatrix,
                            train_mat: RatingMatrix,
                            invalid_users: np.ndarray,
                            invalid_items: np.ndarray,
                            n: int = 10, n_candidates: int = 1000,
                            popularity: "np.ndarray | None" = None,
                            seed: int = 0,
                            blk: int = 1024
                            ) -> Tuple[float, float]:
    """(HR@n, ARHR@n) under the sampled LOO protocol — held-out item
    ranked against ``n_candidates - 1`` sampled negatives (see
    sample_negatives). Scores = the EvalView's estRating; device-side
    blocked scoring, two scalars leave the chip."""
    n_users = view.u_fac.shape[0]
    n_items = view.i_fac.shape[0]
    cands, users = sample_negatives(
        test_mat, train_mat, invalid_users, invalid_items, n_users,
        n_items, n_candidates, popularity, seed)
    if len(users) == 0:
        return 0.0, 0.0
    pad = _round_up(len(users), blk) - len(users)
    users_p = np.pad(users, (0, pad), constant_values=-1)
    cands_p = np.pad(cands, ((0, pad), (0, 0)))
    ub = view.u_bias if view.u_bias is not None \
        else jnp.zeros(n_users, jnp.float32)
    ib = view.i_bias if view.i_bias is not None \
        else jnp.zeros(n_items, jnp.float32)
    mu = view.mu if view.mu is not None else jnp.float32(0.0)
    hr, ar = _sampled_rank_dev(
        view.u_fac, view.i_fac, ub, ib, mu,
        jnp.asarray(users_p), jnp.asarray(cands_p), n, blk)
    return float(hr) / len(users), float(ar) / len(users)


def popularity_ranking_metrics(test_mat: RatingMatrix,
                               train_mat: RatingMatrix,
                               invalid_users: np.ndarray,
                               invalid_items: np.ndarray,
                               n_users: int, n_items: int,
                               n: int = 10, n_candidates: int = 1000,
                               popularity: "np.ndarray | None" = None,
                               seed: int = 0) -> Tuple[float, float]:
    """The popularity-scorer baseline under the SAME sampled protocol
    (score = train frequency): the margin base that makes a parity row
    informative when the full-catalog HR saturates."""
    cands, users = sample_negatives(
        test_mat, train_mat, invalid_users, invalid_items, n_users,
        n_items, n_candidates, popularity, seed)
    if len(users) == 0:
        return 0.0, 0.0
    freq = train_mat.col_degrees().astype(np.float64)
    freq = np.pad(freq, (0, max(n_items - len(freq), 0)))
    sc = freq[cands]
    rank = (sc[:, 1:] > sc[:, :1]).sum(axis=1)
    hr = float((rank < n).mean())
    ar = float(((rank < n) / (rank + 1.0)).mean())
    return hr, ar
